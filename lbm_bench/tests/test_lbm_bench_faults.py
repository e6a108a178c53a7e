"""A whole run with the timed path broken underneath comes out not correct.

Past the harness's look for a card, each case below drives set-up, the
window and the check of a tiny 4-level case on the CPU (as a run of
`sphere_re10m.run` would, held to that configuration's limits), with one
fault planted in the program:
  - a step that returns its state unchanged;
  - half of the batch left out: the cells of every level's upper half in x
    keep their old values;
  - an answer altered where it is produced: one value of the finest
    level's f after each call, the ghost planes of the matrix-product path
    (one part in a thousand of one face's planes), or the drag coefficient
    of each force evaluation.
The exchange between chips cannot be left out: every cell runs on one
card, with no exchange.
"""

import json
import os

import pytest

from lbm_bench import harness


def _limits():
    with open(os.path.join(harness.HERE, "configs", "sphere_re10m", "limits.json")) as fh:
        return json.load(fh)


def _broken_runner(kind):
    from open_ludwig_torch import solver_dense
    real = solver_dense.make_batch_runner_dense

    def make(*args, **kw):
        run = real(*args, **kw)

        def broken(states, t0, n):
            if kind == "unchanged":
                return states
            old = [{k: st[k].clone() for k in ("f", "rho", "vel")} for st in states]
            out = run(states, t0, n)
            for st, o in zip(out, old):
                if kind == "half":
                    X = st["rho"].shape[0]
                    st["f"][:, X // 2:] = o["f"][:, X // 2:]
                    st["rho"][X // 2:] = o["rho"][X // 2:]
                    st["vel"][:, X // 2:] = o["vel"][:, X // 2:]
            if kind == "altered":
                f = out[-1]["f"]
                f[5, f.shape[1] // 2, f.shape[2] // 2, f.shape[3] // 3] += 1e-2
            return out

        for key in ("fused2", "seed_slabs", "graph_set", "graph_note"):
            setattr(broken, key, getattr(run, key))
        return broken

    return make


def _run(case, traffic):
    return harness.run_case(case, traffic, _limits(), 2 ** 31 + 9, 0.0, False, "cpu",
                            0.0, say=lambda m: None)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(kind, tiny_case, tiny_traffic, monkeypatch):
    from open_ludwig_torch import solver_dense
    monkeypatch.setattr(solver_dense, "make_batch_runner_dense", _broken_runner(kind))
    out = _run(tiny_case, tiny_traffic)
    failed = sorted(k for k, c in out["checks"].items() if not c["ok"])
    assert failed, out["checks"]
    assert "end_gap" in failed


def test_an_altered_force_is_not_correct(tiny_case, tiny_traffic, monkeypatch):
    from open_ludwig_torch.ops import forces
    real = forces.compute_aerodynamics

    def altered(state, ctx):
        res = real(state, ctx)
        res.Cd += 1e-3
        return res

    monkeypatch.setattr(forces, "compute_aerodynamics", altered)
    out = _run(tiny_case, tiny_traffic)
    assert not out["checks"]["force_gap"]["ok"], out["checks"]
    assert all(c["ok"] for k, c in out["checks"].items() if k != "force_gap")


def test_altered_ghost_planes_are_not_correct(tiny_case, tiny_traffic, monkeypatch):
    from open_ludwig_torch import solver_dense
    real = solver_dense.interface_planes_pair_mm

    def altered(*args, **kw):
        planes = real(*args, **kw)
        face = sorted(planes)[0]
        planes[face] = planes[face] * 1.001
        return planes

    monkeypatch.setattr(solver_dense, "interface_planes_pair_mm", altered)
    out = _run(tiny_case, tiny_traffic)
    assert not out["checks"]["start_gap"]["ok"], out["checks"]
    assert not out["checks"]["end_gap"]["ok"], out["checks"]
