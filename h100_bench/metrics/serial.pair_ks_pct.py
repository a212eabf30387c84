"""The share of the paired key switches (a MUX or a parallel-prefix level:
two bootstraps summed before one key switch) that the key-switch kernels
summed themselves: ``core.bootstrap.PAIR_KS["kernel"]`` over both routes'
counts at the end of the run (the warm-up's calls included; a replayed graph
counts its capture's, as the launch counters do). A program without the
counter, or with no paired key switch, reports nothing."""


def read(run):
    from tfhe_tpu_torch.core import bootstrap as bs
    routes = getattr(bs, "PAIR_KS", None)
    total = sum(routes.values()) if routes else 0
    return 100.0 * routes.get("kernel", 0) / total if total else None
