"""The share of the adders' parallel-prefix carry chains that ran the
Sklansky network: ``arith.PREFIX_NETWORKS["sklansky"]`` over both networks'
counts at the end of the run (the warm-up's calls included; a replayed graph
counts the chains of its capture, as the launch counters do). A program
without the counter, or with no prefix chain, reports nothing."""


def read(run):
    from tfhe_tpu_torch import arith
    networks = getattr(arith, "PREFIX_NETWORKS", None)
    total = sum(networks.values()) if networks else 0
    return 100.0 * networks.get("sklansky", 0) / total if total else None
