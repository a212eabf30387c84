"""The host's time launching captured graphs, in ms an operation: the
window's ``tfhe.circuit.launch`` spans (the ``graph.replay()`` call) summed,
over the operations completed."""


def read(run):
    from tfhe_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None or not run.jobs:
        return None
    took = [s.duration_ns for s in spans() if s.name == "tfhe.circuit.launch"]
    return 1e-6 * sum(took) / len(run.jobs) if took else None
