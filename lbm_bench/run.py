"""Run one cell of the benchmark once and print its result line.

    python3 lbm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits 2 without a CUDA card (or with fewer
than the cell asks for) and 3 if jax, jaxlib, flax or the JAX package was
loaded, printing no result; a failure raises and prints none either.
Otherwise the last lines of standard error are the numbers compared with
their limits, and the last line of standard output is the result's JSON
object (`harness.result_line`).
"""

import time

T_PROCESS = time.time()  # set-up is counted from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(CACHES)
    sys.path.insert(0, ROOT)
    import torch

    from lbm_bench import harness

    files = harness.cell_files(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("lbm_bench: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    chips = int(files["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"lbm_bench: {torch.cuda.device_count()} CUDA card(s), the cell asks "
              f"for {chips}", file=sys.stderr)
        return 2
    harness.quiet_program_logs()
    out = harness.run_case(files["case_dir"], files["traffic"], files["limits"],
                           args.seed, args.seconds, bool(args.trace), "cuda:0",
                           T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"lbm_bench: loaded {', '.join(bad)}; the port must not", file=sys.stderr)
        return 3
    line = harness.result_line(files, out, bool(args.trace))
    for text in harness.check_lines(out["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
