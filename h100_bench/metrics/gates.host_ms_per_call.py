"""The host's time a gate call: the mean duration, in ms, of the window's
outermost program spans of a gate (``tfhe.gate2`` on one card,
``tfhe.mesh.sharded_gate2`` on rank 0 of several), from the program's span
store (``tfhe_tpu_torch.utils.profiling``), which holds spans only while the
profiler records."""
ROOTS = ("tfhe.gate2", "tfhe.mesh.sharded_gate2")


def read(run):
    from tfhe_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    took = [s.duration_ns for s in spans() if s.parent is None and s.name in ROOTS]
    return 1e-6 * sum(took) / len(took) if took else None
