"""The share of the window's circuit calls (the program's ``tfhe.circuit``
spans) that replayed a captured graph rather than ran eagerly or captured."""


def read(run):
    from tfhe_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    modes = [s.attrs.get("mode") for s in spans() if s.name == "tfhe.circuit"]
    return 100.0 * modes.count("replay") / len(modes) if modes else None
