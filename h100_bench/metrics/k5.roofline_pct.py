"""K5 (csrc/blind_rotate_small.cu blind_rotate_small_kernel) against the
roofline of its batches (roofline.py): the window's K5 launches and samples
by the program's counters (replays of a captured circuit included), their
device time by the trace."""
import devtrace
import roofline
from types import SimpleNamespace


def read(run):
    took = devtrace.kernel_s(run.trace, "blind_rotate_small_kernel")
    if not took:
        return None
    launches, samples = run.counters["launches"], run.counters["samples"]
    if launches["blind_rotate_fused_packed"] == 0:
        return None
    P = SimpleNamespace(**run.config["params"])
    bound = roofline.blind_rotate_bound_s(P, launches["blind_rotate_fused_packed"],
                                          samples["blind_rotate_fused_packed"], fused_ks=False)
    return 100.0 * bound / took
