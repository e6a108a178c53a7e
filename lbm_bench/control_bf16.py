"""Readings for the limits of a configuration stored in bf16 g = f - w: the
program's sound runs over many seeds, and a control one precision below.

    python3 lbm_bench/control_bf16.py --workload <cell> --seeds 12 \\
        --control-seeds 4 --seconds 10 [--first-seed N] [--out FILE]

On a card, in one process, as `control.py` does: the program is built once
(`harness.Program`), and for each seed it runs the cell's set-up from the
warm start, a window of `--seconds` at the cell's own load and the last
steps (`Program.finish`); the reference (`reference.model.Reference`) is
built once and follows the same steps from the same states.  Each seed's
numbers (`harness.gaps`) are one JSON line.

The control is the reference one precision below the configuration's
bf16: `Float8Reference`, whose stored g is rounded through float8 e5m2
(`torch.float8_e5m2`, 2 mantissa bits) after every sub-step of every
level, at `Reference.level_step`'s return, the finest step boundary the
reference's public API has (the stored state after Bouzidi, which the
ghost planes and the level's next sub-step read).  e4m3 would flush the g
of the small-weight directions to zero (its least subnormal is 2^-9), so
e5m2 is the one that rounds rather than erases.  On the first
`--control-seeds` seeds it follows the same steps from the same states as
the reference, and its numbers against the reference's are the seed's
"control".  The last line sums up: per number the largest reading of the
program's seeds (the lower reading) and the smallest of the control's
(the upper).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lbm_bench.reference.model import Reference  # noqa: E402


def round_e5m2(g: torch.Tensor) -> torch.Tensor:
    """`g` rounded to nearest through float8 e5m2, in its own type."""
    return g.to(torch.float8_e5m2).to(g.dtype)


class Float8Reference(Reference):
    """The plain reference with its stored g rounded through e5m2 after
    each sub-step (module docstring)."""

    def __init__(self, case_dir: str, device, cache: bool = True):
        super().__init__(case_dir, device, cache)
        if not self.store_bf16:
            raise ValueError("the float8 control is one precision below bf16 g storage; "
                             "this configuration stores float32 (lbm_bench/control.py)")

    def level_step(self, st: Dict, lvl: int, u: float, seed: int, iface) -> Dict:
        out = super().level_step(st, lvl, u, seed, iface)
        return {**out, "f": round_e5m2(out["f"])}


def readings(case_dir: str, traffic: dict, seeds, control_seeds: int, seconds: float,
             device, say=print):
    """Yield one dict a seed: its numbers for the program and, on the first
    `control_seeds` seeds, for the control."""
    from lbm_bench import compare, harness

    ctrl = Float8Reference(case_dir, device)
    ref = Reference(case_dir, device)
    prog = harness.Program(case_dir, traffic, device, say=say)
    for i, seed in enumerate(seeds):
        t_seed = time.time()
        states, _, _ = prog.warm_up(prog.warm(seed), prog.t0)
        states, t, prog_start = prog.start(seed, states)
        states, t, w = prog.window(states, t, seconds)
        end_in, prog_end, res, stats = prog.finish(states, t)
        del states
        r = harness.reference_states(ref, seed, traffic, prog.t0, t, end_in)
        row = {"seed": seed, "coarse_steps": w["steps"],
               "program": harness.gaps(r, prog_start, prog_end, res, stats)}
        if i < control_seeds:
            c = harness.reference_states(ctrl, seed, traffic, prog.t0, t, end_in)
            row["control"] = harness.gaps(r, c["start"], compare.host_copy(c["end"]),
                                          c["forces"], c["stats"])
            del c
        del r
        harness.free_device(device)
        row["seconds"] = time.time() - t_seed
        yield row


def summary(rows, workload: str, card: str) -> Dict:
    """Per number the program's largest reading (lower) and the control's
    smallest (upper)."""
    out = {"workload": workload, "card": card, "lower": {}, "upper": {}}
    for side, key, pick in (("program", "lower", max), ("control", "upper", min)):
        for name in rows[0]["program"]:
            vals = [r[side][name] for r in rows if side in r]
            if vals:
                out[key][name] = pick(vals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3000000001)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from lbm_bench import harness

    if not torch.cuda.is_available():
        print("control_bf16: no CUDA card", file=sys.stderr)
        return 2
    harness.quiet_program_logs()
    files = harness.cell_files(harness.load_spec(), args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = open(args.out, "w") if args.out else None
    rows = []
    for row in readings(files["case_dir"], files["traffic"], seeds, args.control_seeds,
                        args.seconds, "cuda:0",
                        say=lambda m: print(m, file=sys.stderr, flush=True)):
        rows.append(row)
        lines = [json.dumps(row)]
        if len(rows) == len(seeds):
            lines.append(json.dumps(summary(rows, args.workload, harness.card_line())))
        for line in lines:
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
