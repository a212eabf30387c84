"""Samples bootstrapped in the window (every blind rotate's, by the
program's counters) over the window."""
BLIND_ROTATES = ("blind_rotate_fused", "blind_rotate_ks_fused", "blind_rotate_fused_packed")


def read(run):
    if not run.jobs:
        return None
    return sum(run.counters["samples"][k] for k in BLIND_ROTATES) / run.window_s
