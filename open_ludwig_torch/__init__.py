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
imports only its numpy modules (lattice, config, scaling, geometry, cases,
domain, native, core.patch's host-side box construction) and never jax.
"""

__version__ = "0.1.0"
