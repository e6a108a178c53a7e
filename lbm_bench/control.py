"""Readings for the limits that decide `correct`: the program's sound runs
over many seeds, and the control's.

    python3 lbm_bench/control.py --workload <cell> --seeds 12 --control-seeds 4 \\
        --seconds 10 [--out control_<cell>.jsonl]

On a card, in one process: the program is built once (`harness.Program`),
and for each seed it runs the cell's set-up from the warm start (the
warm-up calls, then the start call from the warm start again), a window
of `--seconds` at the cell's own load and the last steps
(`Program.finish`), as a benchmark run does; the reference
(`reference.model.Reference`) is built once and follows the same steps
from the same states.  Each seed's numbers (`harness.gaps`) are one JSON
line.

The control stands in the program's place, one precision below the
configuration's float32, on the first `--control-seeds` seeds, from the
same states: the program with its own bf16 g = f - w storage switched on
(`precision: bfloat16`), started from the same warm start and from the
window's end state encoded to bf16.  A configuration stored in bf16 has
no control here.
The last line sums up: per number the largest reading of the program's
seeds (the lower reading) and the smallest of the control's (the upper).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_bf16_storage(states):
    """float32 f states as bf16 g = f - w states (the same rho and vel)."""
    from lbm_bench.reference.olt.ops.storage import STORE_BF16, encode_f
    return [{"f": encode_f(st["f"].float(), STORE_BF16), "rho": st["rho"],
             "vel": st["vel"]} for st in states]


def readings(case_dir: str, traffic: dict, seeds, control_seeds: int, seconds: float,
             device, say=print):
    """Yield one dict a seed: its numbers for the program and, on the first
    `control_seeds` seeds, for the control."""
    from lbm_bench import compare, harness
    from lbm_bench.reference.model import Reference

    prog = harness.Program(case_dir, traffic, device, say=say)
    if prog.store_bf16:
        raise ValueError("the control is the program one precision below float32; "
                         "this configuration stores bf16")
    ref = Reference(case_dir, device)
    ctrl = harness.Program(case_dir, traffic, device, precision="bfloat16", say=say)
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
            _, _, c_start = ctrl.start(seed)
            c_in = compare.to_device(to_bf16_storage(end_in), ctrl.dev)
            c_states = ctrl.run(c_in, t, ctrl.check_steps)
            c_res, c_stats = ctrl.events(c_states, True, True)
            c_end = compare.host_copy(c_states)
            del c_states, c_in
            row["control"] = harness.gaps(r, c_start, c_end, c_res, c_stats)
        del r
        harness.free_device(device)
        row["seconds"] = time.time() - t_seed
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3000000001)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from lbm_bench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
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
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    summary = {"workload": args.workload, "card": harness.card_line(),
               "lower": {}, "upper": {}}
    for side, key, pick in (("program", "lower", max), ("control", "upper", min)):
        for name in rows[0]["program"]:
            vals = [r[side][name] for r in rows if side in r]
            if vals:
                summary[key][name] = pick(vals)
    line = json.dumps(summary)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
