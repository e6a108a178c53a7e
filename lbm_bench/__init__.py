"""The benchmark of `open_ludwig_torch` on NVIDIA cards.

    python3 lbm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix or metric sits in a file of its
own that the harness finds by name:

  - `configs/<config>/`: the case as it runs (`config.yaml` and its STL),
    `meta.json` (source, what was cut, what was assumed) and `limits.json`
    (the limits that decide `correct`, with the readings they came from);
  - `traffic/<traffic>.json`: the mix (the warm start's perturbation, the
    coarse steps a runner call takes, the events and their cadence, what
    a traced run traces, what the reference follows);
  - `metrics/<metric>.py`: a reader `read(rec)` of one metric from a run's
    record (`harness.RunRecord`), None where it finds nothing to read;
    `metrics/kernels.json` names the port's kernels by role.

The yardstick lives here too, frozen: the warm start (`warm`), the work
count and the card's peaks (`work`), the trace's arithmetic (`trace`), the
plain reference (`reference/`) and the comparison that decides `correct`
(`compare`).  Nothing under this folder imports jax or the JAX package.
"""
