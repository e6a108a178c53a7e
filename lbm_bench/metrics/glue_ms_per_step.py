"""glue_ms_per_step: device milliseconds a coarse step of the operations of
the runner's steps (not of the events) that are none of the port's
kernels (`kernels.json`): the ghost planes' torch glue, slab copies, the
step record's updates."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.coarse_steps <= 0:
        return None
    total = sum(e - s for n, s, e, what in tr.ops
                if what == "step" and not any(p.search(n) for p in rec.kernels.values()))
    return total / 1e6 / tr.coarse_steps
