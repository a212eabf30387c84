"""The share of the device's kernel time spent outside the blind rotate and
the key switch: the gate's affine stage, the mod switch and test vector
(_prepare_acc), the fused key switch's finish, copies."""
import devtrace

CORE = ("blind_rotate_kernel", "blind_rotate_small_kernel", "ks_gather_kernel",
        "ks_mma_kernel", "ks_finish_kernel")


def read(run):
    s = run.trace
    if s is None:
        return None
    total = sum(s["by_name"].values())
    return 100.0 * (total - devtrace.kernel_s(s, *CORE)) / total
