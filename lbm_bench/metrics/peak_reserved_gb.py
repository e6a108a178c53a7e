"""peak_reserved_gb: the caching allocator's reserved peak over set-up and
window, in GB (1e9 bytes); None off a card."""


def read(rec):
    if rec.peak_reserved_bytes is None:
        return None
    return rec.peak_reserved_bytes / 1e9
