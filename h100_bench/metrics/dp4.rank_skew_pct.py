"""How far the slowest rank's own work lags the fastest's: each rank's
device time outside NCCL kernels over the traced window, the largest over
the smallest, minus 100."""


def read(run):
    own = [sum(t for n, t in r["by_name"].items() if "nccl" not in n)
           for r in run.ranks if r is not None]
    if len(own) < 2 or min(own) <= 0:
        return None
    return 100.0 * (max(own) / min(own) - 1.0)
