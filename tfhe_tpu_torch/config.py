"""Routing configuration: the one module of the port that reads ``os.environ``.

Flags, each with ``tfhe_tpu``'s name and default; :func:`overrides` wins
over the environment:

- ``TFHE_TPU_FUSEKS=0/1``: a bootstrap takes the fused route (blind rotate,
  extract and key switch in one kernel entry point) or the split route (a
  blind-rotate kernel, then the one-hot matmul key switch). Both give the
  same bits. Default: fused on CUDA, split on the CPU, so the CPU route
  mirrors ``tfhe_tpu`` on the CPU.
- ``TFHE_TPU_LOOKAHEAD=0/1``: the parallel-prefix arm of the integer
  circuits instead of the ripple arm (default ripple).
- ``TFHE_TPU_SEPTET=0/1``: 7:3 compressor levels in carry-save reductions
  instead of the full-adder Dadda tree (default the tree).
- ``TFHE_TPU_NOISE_MODEL=average|measured|tracked``: the noise accounting
  the compressor planner certifies against (default "average").
- ``REF_DIR``: the reference checkout that ``ref_oracle`` compiles (default
  ``/root/reference/gpuParallel``, as ``native/Makefile``).

The circuit flags change the bootstraps a circuit runs, never its result.
"""
from __future__ import annotations

import contextlib
import os

import torch

_OVERRIDES: dict = {}


def flag(name: str, default: str = "auto") -> str:
    """Resolve a flag: programmatic override > environment > default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    return os.environ.get(name, default)


@contextlib.contextmanager
def overrides(**kv):
    """Programmatic flag overrides for the duration of the context:
    ``overrides(TFHE_TPU_FUSEKS="0")`` wins over the environment."""
    saved = dict(_OVERRIDES)
    _OVERRIDES.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        _OVERRIDES.clear()
        _OVERRIDES.update(saved)


def fuseks_enabled(device: torch.device) -> bool:
    """Fused key switch for a bootstrap whose tensors live on `device`."""
    v = flag("TFHE_TPU_FUSEKS")
    if v in ("0", "1"):
        return v == "1"
    return torch.device(device).type == "cuda"


def lookahead_enabled(numbers: int, nbits: int) -> bool:
    """Parallel-prefix (Kogge-Stone) circuits instead of ripple ones: off
    unless TFHE_TPU_LOOKAHEAD=1. `numbers` (the independent integers in the
    batch) and `nbits` are the inputs a measured crossover would read."""
    return flag("TFHE_TPU_LOOKAHEAD") == "1"


def septet_enabled(nbits: int) -> bool:
    """7:3 compressor levels in carry-save reductions: off unless
    TFHE_TPU_SEPTET=1. Bits already encoded at +-1/16 take the septet engine
    regardless (arith._wallace_sum_bits)."""
    return flag("TFHE_TPU_SEPTET") == "1"


def noise_model() -> str:
    """The noise-accounting model the compressor planner certifies against
    (utils.phasesim.max_live16): "average" (default), "measured" or
    "tracked"."""
    v = flag("TFHE_TPU_NOISE_MODEL", "average")
    if v not in ("average", "measured", "tracked"):
        raise ValueError(f"TFHE_TPU_NOISE_MODEL={v!r}: want average|measured|tracked")
    return v


def ref_dir() -> str:
    """Location of the reference checkout (the reference-oracle build)."""
    return flag("REF_DIR", "/root/reference/gpuParallel")
