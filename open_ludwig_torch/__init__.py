"""open_ludwig_torch: the PyTorch/CUDA port of open_ludwig_tpu.

The production `layout: patch` solve on one NVIDIA GPU: dense nested
refinement boxes, 2:1 multi-level time stepping with temporally
interpolated ghost planes, bf16 g = f - w storage, Bouzidi bounce-back on
the finest level and surface-stress forces.  Every stream-collide sub-step
and every Bouzidi correction runs through a hand-written CUDA kernel
(`csrc/`, bound in `ops/cuda_step.py`); on CPU tensors the same wrappers
run the plain PyTorch versions in `ops/dense_step.py`, which the tests
hold against the JAX package.

The JAX package `open_ludwig_tpu` stays the reference.  This package
imports nothing of it and never jax: it carries its own copies of the
host modules it needs (lattice, config, geometry, scaling, cases, native,
domain, core.patch), which `tests/test_torch_host_modules.py` holds to
the reference's arrays.  Only the tests import both packages.
"""

__version__ = "0.1.0"
