"""event_ms: the mean host time of the window's untraced events (forces,
flow statistics), from the drained card to their values on the host."""


def read(rec):
    if not rec.event_ms:
        return None
    return sum(rec.event_ms) / len(rec.event_ms)
