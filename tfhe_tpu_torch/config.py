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
- ``TFHE_TPU_CIRCUIT_JIT=0/1``: a decorated integer circuit
  (``arith.circuit``) is captured once as a CUDA graph and replayed (default
  on for CUDA tensors); CPU tensors always run eagerly.
- ``REF_DIR``: the reference checkout that ``ref_oracle`` compiles (default
  ``/root/reference/gpuParallel``, as ``native/Makefile``).

The circuit flags change the bootstraps a circuit runs, never its result;
``policy_fingerprint`` names everything that routes a call, so that a graph
captured under one route is never replayed under another.
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


def circuit_jit_enabled(device: torch.device) -> bool:
    """Whole-circuit graphs (``arith.circuit``) for a circuit whose
    ciphertexts lie on `device`: TFHE_TPU_CIRCUIT_JIT=0/1 forces, auto is on
    for CUDA tensors. A CUDA graph holds only CUDA work, so ``arith.circuit``
    runs CPU tensors eagerly whatever this says (the caller asked for the CPU)."""
    v = flag("TFHE_TPU_CIRCUIT_JIT")
    if v in ("0", "1"):
        return v == "1"
    return torch.device(device).type == "cuda"


def policy_fingerprint(device=None, cloud=None) -> tuple:
    """Everything a circuit reads at call time that picks its kernels and
    batches: the circuit flags, the routing values of ``ops.cmux`` (the key
    switch's arms, the blind rotate's forms) and ``core.bootstrap`` (the
    small-batch route and its wave times) and, with `device` and `cloud`, the
    batch cap of a bootstrap call there. Part of the key of a captured
    circuit: a graph bakes in the route of its capture, so changing any of
    these (chip_smoke.py forces ``cmux.KS_GATHER_MAX = 0`` between calls)
    captures a graph of its own instead of replaying another route."""
    from .core import bootstrap as bs
    from .ops import cmux
    cap = None if device is None or cloud is None else bs.batch_cap(torch.device(device), cloud)
    return (flag("TFHE_TPU_LOOKAHEAD"), flag("TFHE_TPU_SEPTET"), flag("TFHE_TPU_FUSEKS"),
            flag("TFHE_TPU_NOISE_MODEL", "average"),
            cmux.KS_GATHER_MAX, cmux.KS_GATHER_BLOCKS, cmux.KS_GATHER_MIN_COEFFS,
            cmux.KS_MMA_BLOCKS, cmux.CMUX_FORMS,
            bs.SMALL_BATCH_MAX, bs.K5_WAVE, bs.K5_WAVE_MS, bs.K5_TAIL_MS, bs.K3_WAVE,
            bs.K3_WAVE_MS, cap)


def ref_dir() -> str:
    """Location of the reference checkout (the reference-oracle build)."""
    return flag("REF_DIR", "/root/reference/gpuParallel")
