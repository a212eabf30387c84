"""NCCL kernels' device time over rank 0's traced window."""
import devtrace


def read(run):
    if run.trace is None or len(run.ranks) < 2:
        return None
    return 100.0 * devtrace.kernel_s(run.trace, "nccl") / run.trace["window_s"]
