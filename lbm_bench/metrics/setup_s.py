"""setup_s: seconds from the process's start to the window's first call."""


def read(rec):
    return rec.setup_s
