"""Routing configuration: the one module of the port that reads ``os.environ``.

Flags, each with ``tfhe_tpu``'s name and default; :func:`overrides` wins
over the environment:

- ``TFHE_TPU_FUSEKS=0/1``: a bootstrap takes the fused route (blind rotate,
  extract and key switch in one kernel entry point) or the split route (a
  blind-rotate kernel, then the one-hot matmul key switch). Both give the
  same bits. Default: fused on CUDA, split on the CPU, so the CPU route
  mirrors ``tfhe_tpu`` on the CPU.
- ``TFHE_TPU_LOOKAHEAD=0/1``: the parallel-prefix arm of the integer
  adders or the ripple arm. Default: on the CPU ripple, as ``tfhe_tpu``; on
  CUDA the arm whose stages cost less on the card for the call's numbers and
  width (``arith._latency_policy``): prefix for a few numbers, ripple for many.
- ``TFHE_TPU_SEPTET=0/1``: 7:3 compressor levels in carry-save reductions
  instead of the full-adder Dadda tree (default the tree).
- ``TFHE_TPU_NOISE_MODEL=average|measured|tracked``: the noise accounting
  the compressor planner certifies against (default "average").
- ``TFHE_TPU_CIRCUIT_JIT=0/1``: a decorated integer circuit
  (``arith.circuit``) is captured once as a CUDA graph and replayed (default
  on for CUDA tensors); CPU tensors always run eagerly.
- ``REF_DIR``: the reference checkout that ``ref_oracle`` compiles (default
  ``/root/reference/gpuParallel``, as ``native/Makefile``).

The circuit flags change the bootstraps a circuit runs, never its result;
they are part of the key of a captured circuit (``arith.circuit_key``). This
module imports nothing of the port: routes are priced where they run.
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


def circuit_jit_enabled(device: torch.device) -> bool:
    """Whole-circuit graphs (``arith.circuit``) for a circuit whose
    ciphertexts lie on `device`: TFHE_TPU_CIRCUIT_JIT=0/1 forces, auto is on
    for CUDA tensors. A CUDA graph holds only CUDA work, so ``arith.circuit``
    runs CPU tensors eagerly whatever this says (the caller asked for the CPU)."""
    v = flag("TFHE_TPU_CIRCUIT_JIT")
    if v in ("0", "1"):
        return v == "1"
    return torch.device(device).type == "cuda"


def ref_dir() -> str:
    """Location of the reference checkout (the reference-oracle build)."""
    return flag("REF_DIR", "/root/reference/gpuParallel")
