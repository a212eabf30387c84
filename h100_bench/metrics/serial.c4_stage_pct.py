"""The share of the small-batch blind rotate's stages (K5 launches) that ran
in clusters of four CTAs a sample, the cheaper form: ``ops.cmux_packed.CLUSTERS``
(K5 launches by cluster, "c4" or "c2") at the end of the run (the warm-up's
launches included; a replayed graph counts its capture's, as the launch
counters do). A program without the counter, or with no K5 launch, reports
nothing."""


def read(run):
    from tfhe_tpu_torch.ops import cmux_packed
    clusters = getattr(cmux_packed, "CLUSTERS", None)
    if not clusters:
        return None
    c4, c2 = clusters.get("c4", 0), clusters.get("c2", 0)
    return 100.0 * c4 / (c4 + c2) if c4 + c2 else None
