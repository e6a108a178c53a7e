"""stream_collide_roofline: the least time the card could take for the
traced coarse steps' stream-collide sub-steps (`work.steps_least_seconds`:
`work.step_work` per level and sub-step, at the card's published peaks)
over the device time of the kernels that ran them (`kernels.json`
"stream_collide"), in %."""

from lbm_bench import work


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    least = work.steps_least_seconds(rec.levels, rec.store_bf16, rec.wall_model,
                                     tr.coarse_steps, rec.device_name)
    spent = tr.seconds(rec.kernels["stream_collide"])
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent
