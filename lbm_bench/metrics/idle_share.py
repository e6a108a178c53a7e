"""idle_share: the share of the traced window in which no operation ran on
the card, in %."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)
