"""mlups_su: million site updates a second over the whole window, events
included; a level's cells count 2^(l-1) times a coarse step."""


def read(rec):
    return rec.coarse_steps * rec.updates_per_coarse / rec.window_s / 1e6
