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
  width (``lookahead_enabled``): prefix for a few numbers, ripple for many.
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


def adder_stages(numbers: int, nbits: int) -> tuple:
    """The flat batch of each dependent bootstrap of an nbits add of
    `numbers` independent integers, in each arm: ripple, one full adder (two
    images a number) a bit; prefix (``arith.add_fast``), the (g, p) pair over
    every bit, a Kogge-Stone level of three images a combined bit for each
    distance 1, 2, 4, ... under nbits, and the XOR of the sums."""
    ripple = [2 * numbers] * nbits
    prefix = [2 * nbits * numbers]
    d = 1
    while d < nbits:
        prefix.append(3 * (nbits - d) * numbers)
        d *= 2
    prefix.append((nbits - 1) * numbers)
    return ripple, [b for b in prefix if b]


def lookahead_enabled(numbers: int, nbits: int, device=None, in_flight: int = 0,
                      params=None) -> bool:
    """Parallel-prefix (Kogge-Stone) adders instead of ripple ones for
    `numbers` independent nbits integers on `device`. TFHE_TPU_LOOKAHEAD=0/1
    forces either arm. Auto: ripple on the CPU (and with no device), as
    ``tfhe_tpu``, so the CPU route stays byte-equal to it; on CUDA the arm
    whose stages (``adder_stages``) cost less by ``core.bootstrap.stage_ms``
    at the keys' parameter set `params` (needed there), with `in_flight` the
    samples the card holds at once in clusters of four.

    Why by the card's cost. A bootstrap on the H100 costs by dependent stage,
    not by sample: K5 runs 500 dependent CMux steps whatever its batch, ~1.9
    ms a stage from 1 to 30 samples, so a one-number add16 pays 16 ripple
    stages (~31 ms) where prefix pays 6 stages of 15-45 samples. At 32 or 64
    numbers prefix's first stages pass a thousand samples and run as K3/K4
    waves of ~6.2 ms, and ripple's 16 short stages win. The record on a TPU
    went the other way: there a small batch's cost grew with its samples,
    and round 5 of ``tfhe_tpu`` measured div16 at 0.83 s with ripple rounds
    and 3.10 s with prefix rounds, so ``tfhe_tpu`` keeps ripple everywhere."""
    v = flag("TFHE_TPU_LOOKAHEAD")
    if v in ("0", "1"):
        return v == "1"
    if device is None or torch.device(device).type != "cuda":
        return False
    from .core.bootstrap import stage_ms
    ripple, prefix = adder_stages(numbers, nbits)
    return (sum(stage_ms(b, in_flight, params) for b in prefix)
            < sum(stage_ms(b, in_flight, params) for b in ripple))


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
    small-batch route, its wave times and the stage times the adders' arm is
    chosen by) and, with `device` and `cloud`, the
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
            cmux.KS_MMA_BLOCKS, tuple(cmux.CMUX_FORMS.items()),
            tuple(bs.WAVES.items()), cap)


def ref_dir() -> str:
    """Location of the reference checkout (the reference-oracle build)."""
    return flag("REF_DIR", "/root/reference/gpuParallel")
