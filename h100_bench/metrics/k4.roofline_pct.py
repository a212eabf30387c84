"""K4 (csrc/cmux.cu blind_rotate_kernel and its fused key switch) against
the roofline of its batches (roofline.py): the window's K4 launches and
samples by the program's counters, their device time by the trace. Read
only where K4 is the one blind rotate the window ran."""
import devtrace
import roofline
from types import SimpleNamespace


def read(run):
    if run.trace is None:
        return None
    launches, samples = run.counters["launches"], run.counters["samples"]
    if (launches["blind_rotate_ks_fused"] == 0
            or launches["blind_rotate_fused"] or launches["blind_rotate_fused_packed"]):
        return None
    took = devtrace.kernel_s(run.trace, "blind_rotate_kernel", "ks_mma_kernel",
                             "ks_gather_kernel", "ks_finish_kernel")
    P = SimpleNamespace(**run.config["params"])
    bound = roofline.blind_rotate_bound_s(P, launches["blind_rotate_ks_fused"],
                                          samples["blind_rotate_ks_fused"], fused_ks=True)
    return 100.0 * bound / took
