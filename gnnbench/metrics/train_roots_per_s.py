"""train_roots_per_s: labelled roots trained per second, every root of
every step completed in the window over the window's wall time (host
clock, from a synchronize to the synchronize after the last whole
K-step replay)."""


def read(rec):
    return rec["window_steps"] * rec["roots_per_step"] / rec["window_s"]
