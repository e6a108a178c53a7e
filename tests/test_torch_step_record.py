"""The step record and the batch as one program, on the CPU.

- `solver.StepRecord`: its speed table equals `ramp_velocity` bit for bit
  for t across the ramp and past it, read on the host (`StepRef.host`) and
  computed in the device-side form (`StepRef.tensors`);
- the seeds: on 1-4-level schedules the graphed schedule hands each launch
  of each level and sub-step the inlet speed and seed of the eager
  schedule (its `t_sub % 1000000`), also across the 10^6 wrap of the seed;
- the graphed runner's steps (fixed buffers and the record; the CPU has
  no graphs, so they run eagerly) equal the eager list runner bit for bit
  over calls that cross `ramp_steps`, on 1 level (the pair runner, odd and
  even calls), 2 and 3 levels, and with K5 in place on the single level and
  on the parent of 2 (its f updated in place, the child's slabs carried),
  float32 and bf16; and stay within 2e-5
  (bf16 2e-3) of the JAX runner's XLA path from one state;
- a state passed in that is not the runner's last result is copied into
  its buffers; the blocks layout's graphed runner equals its eager loop;
- `hash_noise` takes a 0-d tensor seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat_jax
from open_ludwig_tpu import solver_dense as sd_jax
from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.ops import storage as storage_jax

from open_ludwig_torch import checks, convert, solver
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.core.state import build_all
from open_ludwig_torch.domain.builder import setup_case
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.ops import storage
from open_ludwig_torch.ops.collide_math import hash_noise
from open_ludwig_torch.scaling import compute_domain_params

torch.set_num_threads(2)

RAMP = 3
CALLS = ((1, 3), (4, 2), (6, 1))  # t = 1 .. 6 across the ramp, odd and even calls


def _case(d, num_levels, resolution=8, **over):
    make_case_sphere(d, "1M", surface_resolution=resolution, num_levels=num_levels,
                     steps=6, ramp_steps=RAMP, output_freq=100, diag_freq=100,
                     wake_enabled=False, inlet_turbulence=0.02, **over)
    checks.edit_config(d, {"advanced.high_re.min_coarse_blocks": 1})
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params, build_patches(cfg, mesh, params)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """1-, 2-, 3- and 4-level spheres (the single level coarser, to stay
    small)."""
    out = {}
    for nl in (1, 2, 3, 4):
        out[nl] = _case(str(tmp_path_factory.mktemp(f"lev{nl}")), nl,
                        resolution=6 if nl == 1 else 8)
        assert len(out[nl][3]) == nl
    return out


def _random_states(levels, precision, seed):
    rng = np.random.default_rng(seed)
    states = []
    for p in levels:
        sh = tuple(p.interior)
        f = lat_jax.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal((27,) + sh))
        states.append({
            "f": storage.encode_f(torch.as_tensor(f.astype(np.float32)), precision),
            "rho": torch.as_tensor((1 + 0.01 * rng.standard_normal(sh)).astype(np.float32)),
            "vel": torch.as_tensor((0.02 * rng.standard_normal((3,) + sh)).astype(np.float32)),
        })
    return states


def _equal(a, b):
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return all(torch.equal(bits(x[k]), bits(y[k])) for x, y in zip(a, b)
               for k in ("f", "rho", "vel"))


@pytest.mark.parametrize("ramp", [0, 1, 20])
def test_record_speed_table_is_ramp_velocity(ramp):
    u_target = 0.0295
    rec = solver.StepRecord(u_target, ramp, "cpu")
    assert rec.last == ramp + 1 and rec.u.dtype == torch.float32
    for t in range(0, ramp + 40):
        rec.set(t)
        for dt in (0, 1):
            want = np.float32(solver.ramp_velocity(t + dt, u_target, ramp))
            u_host, _ = rec.ref(dt).host()
            u_dev, _ = rec.ref(dt).tensors()
            assert np.float32(u_host).view(np.int32) == want.view(np.int32), (t, dt)
            assert u_dev.dtype == torch.float32 and u_dev.dim() == 0
            assert u_dev.numpy().view(np.int32) == want.view(np.int32), (t, dt)


def test_record_seeds_wrap_as_the_schedule():
    rec = solver.StepRecord(0.03, 2, "cpu")
    for t in (1, 2, 3, 124_999, 499_999, 999_998, 999_999, 1_000_000, 1_000_001):
        rec.set(t)
        for shift in range(4):
            for k in range(2 ** shift):
                want = ((t << shift) + k) % 1000000
                assert rec.ref(0, shift, k).host()[1] == want
                assert int(rec.ref(0, shift, k).tensors()[1]) == want
        assert rec.ref(1).host()[1] == (t + 1) % 1000000


def test_hash_noise_takes_a_tensor_seed():
    gy = torch.arange(40, dtype=torch.int32).repeat(7)
    gz = torch.arange(7, dtype=torch.int32).repeat_interleave(40)
    for seed in (0, 17, 999_999):
        assert torch.equal(hash_noise(gy, gz, seed),
                           hash_noise(gy, gz, torch.tensor(seed, dtype=torch.int64)))


@pytest.mark.parametrize("num_levels", [1, 2, 3, 4])
def test_graphed_schedule_hands_each_launch_the_eager_numbers(cases, num_levels,
                                                              monkeypatch):
    """Every launch of every level and sub-step: the eager schedule's
    (u_inlet, t_seed) and the graphed schedule's record entry read back are
    the same numbers, in the same order, t crossing the seed's 10^6 wrap."""
    cfg, _, params, levels = cases[num_levels]
    statics = sd.build_patch_statics(cfg, levels)
    calls = []

    def spy(name, fn, pair=False):
        def wrapped(f, vel, u, seed, static, patch, *a, **kw):
            if pair:
                got = [x.host() if hasattr(x, "record") else (x, s)
                       for x, s in zip(u, seed)]
            else:
                got = [u.host() if hasattr(u, "record") else (u, seed)]
            calls.append((name, patch.level_id, [(float(a_), int(b_)) for a_, b_ in got]))
            return fn(f, vel, u, seed, static, patch, *a, **kw)
        return wrapped

    for name in ("stream_collide", "stream_collide_flat", "stream_collide_inplace"):
        monkeypatch.setattr(sd, name, spy(name, getattr(sd, name)))
    monkeypatch.setattr(sd, "fused_pair", spy("fused_pair", sd.fused_pair, pair=True))
    seen = {}
    for graphs in (False, True):
        run = sd.make_batch_runner_dense(cfg, params, levels, statics, graphs=graphs)
        states = [sd.init_patch_state(p, cfg.precision) for p in levels]
        calls.clear()
        for t0, n in ((999_998, 3), (1_000_001, 2)):
            run(states, t0, n)
        seen[graphs] = list(calls)
    assert seen[True] == seen[False] and len(seen[True]) > 0
    # and the seeds are the schedule's t_sub % 10^6 for every sub-step
    seeds = sorted(s for _, lvl, got in seen[True] for _, s in got)
    steps = range(999_998, 1_000_003)
    if num_levels == 1:
        want = sorted(t % 1000000 for t in steps)
    else:
        want = sorted(((t << (lv - 1)) + k) % 1000000 for t in steps
                      for lv in range(1, num_levels + 1) for k in range(2 ** (lv - 1)))
    assert seeds == want


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_levels", [1, 2, 3])
def test_graphed_runner_equals_the_eager_loop(cases, num_levels, precision):
    cfg, _, params, levels = cases[num_levels]
    cfg = dataclasses.replace(cfg, precision=precision)
    statics = sd.build_patch_statics(cfg, levels)
    out = {}
    for graphs in (False, True):
        run = sd.make_batch_runner_dense(cfg, params, levels, statics, graphs=graphs)
        states = _random_states(levels, precision, 5)
        for t0, n in CALLS:
            states = run(states, t0, n)
        out[graphs] = states
        if graphs:
            assert run.graph_set is not None and run.graph_set.graphs == {}
    assert _equal(out[True], out[False])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_levels", [1, 2])
def test_graphed_runner_equals_the_eager_loop_k5(cases, num_levels, precision):
    """Level 1 forced onto K5 (in place): the graphed runner's steps keep
    its one f buffer (K2 in place after it, as on the card), and equal the
    eager loop bit for bit."""
    cfg, _, params, levels = cases[num_levels]
    cfg = dataclasses.replace(cfg, precision=precision)
    statics = sd.build_patch_statics(cfg, levels)
    statics[0] = {**statics[0], "engine": "inplace", "engine_why": "forced"}
    out = {}
    for graphs in (False, True):
        run = sd.make_batch_runner_dense(cfg, params, levels, statics, graphs=graphs,
                                         fuse2=True)
        assert run.fused2 == (num_levels > 1)
        states = _random_states(levels, precision, 9)
        f0 = states[0]["f"]
        for t0, n in CALLS:
            states = run(states, t0, n)
            if graphs:
                assert states[0]["f"].data_ptr() == f0.data_ptr()
        out[graphs] = states
    assert _equal(out[True], out[False])


def test_graphed_runner_copies_in_foreign_states(cases):
    """A call given other tensors than the runner's last result starts from
    them (copied into the runner's buffers), as a fresh runner would."""
    cfg, _, params, levels = cases[2]
    statics = sd.build_patch_statics(cfg, levels)
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    run(_random_states(levels, cfg.precision, 1), 1, 2)
    got = run(_random_states(levels, cfg.precision, 2), 3, 2)
    fresh = sd.make_batch_runner_dense(cfg, params, levels, statics)
    want = fresh(_random_states(levels, cfg.precision, 2), 3, 2)
    assert _equal(got, want)
    # a state without carried slabs gets its own
    again = run([{k: v.clone() for k, v in st.items() if k != "_ifsl"}
                 for st in _random_states(levels, cfg.precision, 2)], 3, 2)
    assert _equal(again, want)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_graphed_runner_matches_jax(cases, precision):
    """The graphed runner from one random state against the JAX runner's
    XLA path over a batch that crosses ramp_steps: 2e-5, bf16 2e-3."""
    cfg, mesh, params, levels_t = cases[2]
    cfg = dataclasses.replace(cfg, precision=precision)
    cfg_j = dataclasses.replace(load_case_config_jax(cfg.case_dir), precision=precision)
    levels_j = build_patches_jax(cfg_j, mesh, params)
    statics_j = sd_jax.build_patch_statics(cfg_j, levels_j)
    statics_t = sd.build_patch_statics(cfg, levels_t)
    rng = np.random.default_rng(11)
    states_j = []
    for p in levels_j:
        f = (lat_jax.W[:, None, None, None]
             * (1 + 0.03 * rng.standard_normal((27,) + p.padded))).astype(np.float32)
        states_j.append({
            "f": storage_jax.encode_f(jnp.asarray(f), precision),
            "rho": jnp.asarray((1 + 0.01 * rng.standard_normal(p.padded)).astype(np.float32)),
            "vel": jnp.asarray((0.02 * rng.standard_normal((3,) + p.padded)).astype(np.float32)),
        })
    states_t = [convert.state_from_jax({k: np.asarray(v) for k, v in s.items()}, p)
                for s, p in zip(states_j, levels_j)]
    run_j = sd_jax.make_batch_runner_dense(cfg_j, params, levels_j, statics_j,
                                           use_pallas=False)
    states_j = run_j(states_j, np.int32(2), RAMP)
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t, statics_t)
    states_t = run_t(states_t, 2, 1)
    states_t = run_t(states_t, 3, RAMP - 1)
    tol = 2e-3 if precision == "bfloat16" else 2e-5
    for li, (p, sj, st) in enumerate(zip(levels_j, states_j, states_t)):
        want = {key: convert.trim(np.asarray(sj[key]).astype(np.float32), p.interior)
                for key in ("f", "rho", "vel")}
        got = convert.state_to_numpy(st)
        for key in want:
            d = np.abs(got[key] - want[key]).max()
            assert d < tol, (li, key, d)


def test_blocks_graphed_runner_equals_the_eager_loop(cases):
    cfg = cases[1][0].with_overrides(layout="blocks")
    _, params, levels = setup_case(cfg)
    out = {}
    for graphs in (False, True):
        states, statics = build_all(cfg, params, levels, "cpu")
        gen = torch.Generator().manual_seed(3)
        for st in states:
            st["f"] = st["f"] * (1 + 0.03 * torch.randn(st["f"].shape, generator=gen))
        run = solver.make_batch_runner(cfg, params, statics, graphs=graphs)
        for t0, n in CALLS:
            states = run(states, t0, n)
        out[graphs] = states
    assert _equal(out[True], out[False])


def test_flow_stats_in_runs_of_planes(monkeypatch):
    """`compute_flow_stats` reduces a large level in runs of planes, so the
    events between graph replays add little beside the two state buffers:
    the extrema and the fluid count equal the one-run reduction's, the
    float32 sums agree to rounding."""
    from open_ludwig_torch import diagnostics

    gen = torch.Generator().manual_seed(0)
    sh = (64, 20, 24)
    state = {"rho": 1 + 0.01 * torch.randn(sh, generator=gen),
             "vel": 0.02 * torch.randn((3,) + sh, generator=gen)}
    obstacle = torch.rand(sh, generator=gen) < 0.1
    whole = diagnostics.compute_flow_stats(state, obstacle)
    monkeypatch.setattr(diagnostics, "STATS_CHUNK", 7 * 20 * 24)
    runs = diagnostics.compute_flow_stats(state, obstacle)
    assert (runs.n_fluid, runs.rho_min, runs.rho_max, runs.v_max) == \
        (whole.n_fluid, whole.rho_min, whole.rho_max, whole.v_max)
    assert abs(runs.rho_mean - whole.rho_mean) < 1e-6
    assert abs(runs.kinetic_energy - whole.kinetic_energy) < 1e-5 * whole.kinetic_energy
