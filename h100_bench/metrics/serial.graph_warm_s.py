"""The host's seconds in the circuits' eager calls before their capture and
in the captures: ``arith.GRAPHS.seconds["eager"]`` and ``["capture"]``
summed at the end of the run, the part of the warm-up that
``arith.CAPTURE_AFTER`` sets. A key's first call is left out: the process's
first holds the library's lazy set-up, in a fresh checkout its nvcc build."""
WARM = ("eager", "capture")


def read(run):
    from tfhe_tpu_torch import arith
    seconds = getattr(arith.GRAPHS, "seconds", None)
    took = sum(seconds.get(mode, 0.0) for mode in WARM) if seconds else 0.0
    return took or None
