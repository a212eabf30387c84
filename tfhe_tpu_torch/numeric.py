"""Torus32 numeric primitives on torch tensors, with exact integer semantics.

Port of ``tfhe_tpu.numeric`` (the reference's `gpuParallel/numeric-functions.cu`).
Torus32 = int32 read as a real in [-1/2, 1/2) scaled by 2^32. torch has no
usable uint32 arithmetic, so every Torus32 value is an int32 tensor (``+``,
``-`` and ``*`` wrap mod 2^32). int32 ``>>`` in torch is arithmetic, not
logical; each right shift below is followed by a mask that keeps only bits
that came from the word, which makes it equal to the logical shift.
"""
from __future__ import annotations

import numpy as np
import torch


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor of the same value mod 2^32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def i32(v: int) -> int:
    """A Python int taken mod 2^32 as a signed int32 value."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def dtot32(d: torch.Tensor) -> torch.Tensor:
    """double->Torus32 (ref numeric-functions.cu:34): fractional part scaled by 2^32.

    Only used for small noise values (|d| << 1)."""
    frac = d - torch.trunc(d)
    return (frac * (2.0 ** 32)).to(torch.int32)


def t32tod(x: torch.Tensor) -> torch.Tensor:
    """Torus32->double in [-1/2, 1/2) (ref numeric-functions.cu:38), as float32
    like ``tfhe_tpu.numeric.t32tod``."""
    return x.to(torch.int32).to(torch.float32) / (2.0 ** 32)


def _is_pow2(Msize: int) -> bool:
    return Msize & (Msize - 1) == 0


def _u32_np(x: torch.Tensor) -> np.ndarray:
    return (x.cpu().numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)


def mod_switch_from_torus32(phase: torch.Tensor, Msize: int) -> torch.Tensor:
    """Nearest multiple index: round(phase * Msize / 2^32) mod Msize.

    Exact port of ref numeric-functions.cu:60-67. Power-of-two Msize (the hot
    case, Msize = 2N) stays on the tensor's device; any other Msize uses the
    reference's uint64 formula on the host."""
    if _is_pow2(Msize):
        shift = 32 - Msize.bit_length() + 1           # 32 - log2(Msize)
        u = phase + i32(1 << (shift - 1))              # wraps mod 2^32
        return (u >> shift) & (Msize - 1)
    interv = np.uint64((((1 << 63) // Msize) * 2) & 0xFFFFFFFFFFFFFFFF)
    phase64 = (_u32_np(phase) << np.uint64(32)) + interv // np.uint64(2)
    out = (phase64 // interv).astype(np.int64).astype(np.int32)
    return torch.from_numpy(out).to(phase.device)


def approx_phase(phase: torch.Tensor, Msize: int) -> torch.Tensor:
    """Round a phase to the nearest multiple of 1/Msize (ref
    numeric-functions.cu:47-56). Power-of-two Msize stays on the tensor's
    device (an arithmetic shift right, then left, clears the same low bits as
    the logical one); any other Msize uses the reference's uint64 formula on
    the host."""
    if _is_pow2(Msize):
        shift = 32 - Msize.bit_length() + 1
        u = phase + i32(1 << (shift - 1))              # wraps mod 2^32
        return (u >> shift) << shift
    interv = np.uint64((((1 << 63) // Msize) * 2) & 0xFFFFFFFFFFFFFFFF)
    phase64 = (_u32_np(phase) << np.uint64(32)) + interv // np.uint64(2)
    phase64 -= phase64 % interv
    out = ((phase64 >> np.uint64(32)) & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    return torch.from_numpy(out).to(phase.device)


def resolve_device(device=None) -> torch.device:
    """The device of an entry point that stands alone: `device` if given, else
    the card. The port runs on the card unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: tfhe_tpu_torch runs on the card "
                           "unless the caller passes device='cpu'")
    return torch.device("cuda")


def mod_switch_to_torus32(mu, Msize: int, device=None) -> torch.Tensor:
    """mu -> Torus32 value mu/Msize (ref numeric-functions.cu:72-78). A tensor
    mu keeps its device unless `device` is given; any other mu goes to
    `device`, the card when None."""
    if not (isinstance(mu, torch.Tensor) and device is None):
        device = resolve_device(device)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device)
    interv = ((1 << 63) // Msize) * 2
    if _is_pow2(Msize):
        return mu * i32(interv >> 32)
    phase64 = (mu.cpu().numpy().astype(np.int64).astype(np.uint64)
               * np.uint64(interv & 0xFFFFFFFFFFFFFFFF))
    out = (phase64 >> np.uint64(32)).astype(np.int64).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(out)).to(mu.device)


def gaussian32(message: torch.Tensor, sigma: float,
               generator: torch.Generator) -> torch.Tensor:
    """message + dtot32(N(0, sigma)) (ref numeric-functions.cu:22-29).

    sigma == 0 returns the exact message and draws nothing."""
    if sigma == 0.0:
        return message
    err = torch.randn(message.shape, generator=generator, dtype=torch.float32,
                      device=message.device) * sigma
    return message + dtot32(err)


def uniform_torus32(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform Torus32 samples (ref uniformTorus32_distrib)."""
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=generator,
                         dtype=torch.int32, device=device)
