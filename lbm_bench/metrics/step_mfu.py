"""step_mfu: the share of the card's peak the whole traced window reaches:
the least time of its coarse steps' stream-collide work (as
stream_collide_roofline counts it) over the traced window's length, in %.
It bounds every kernel's share from below, whatever kernels run."""

from lbm_bench import work


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_ns <= 0:
        return None
    least = work.steps_least_seconds(rec.levels, rec.store_bf16, rec.wall_model,
                                     tr.coarse_steps, rec.device_name)
    if least is None:
        return None
    return 100.0 * least / (tr.window_ns / 1e9)
