"""Exact negacyclic NTT over two CRT primes, in numpy (tables) and plain torch.

Port of ``tfhe_tpu.ntt``. Negacyclic torus-polynomial products are computed
exactly with number-theoretic transforms over two ~30-bit primes and a CRT
lift to Torus32 (int32 wrap): no transform noise. Merged-twist transforms
(psi-powers folded into the twiddles), DIF forward (natural -> bit-reversed)
and DIT inverse (bit-reversed -> natural), so no bit-reversal permutation.

The numpy tables are the same arrays ``tfhe_tpu.ntt`` builds, Shoup
precomputations included (the CUDA kernels use them). The plain-torch
transforms hold residues in int64 (p < 2^30, so a product of two residues
fits) and reduce with ``%``, which is exact; they are the CPU path and the
plain versions the kernels are checked against.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .numeric import wrap_i32

# Two NTT-friendly primes < 2^30 with 2^24 | p-1 (so any N <= 2^23 works).
P1 = 998244353   # 119 * 2^23 + 1, generator 3
P2 = 754974721   # 45  * 2^24 + 1, generator 11
GENERATORS = {P1: 3, P2: 11}
PRIMES = (P1, P2)


# --------------------------------------------------------------------------
# numpy tables
# --------------------------------------------------------------------------

def shoup(w: np.ndarray, p: int) -> np.ndarray:
    """Shoup precomputation floor(w * 2^32 / p) for a numpy array of values < p."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def ntt_tables(N: int, p: int):
    """Merged-twist twiddle tables for the size-N negacyclic NTT mod p.

    Returns a dict of numpy uint32 arrays:
      psi_br / psi_br_shoup       : forward table, psi^brv(i), length N
      ipsi_br / ipsi_br_shoup     : inverse table, psi^-brv(i), length N
      n_inv / n_inv_shoup         : scalar N^-1 for the final inverse stage
      ipsi1_ninv / ..._shoup      : ipsi_br[1] * N^-1 (folded last-stage twiddle)
    """
    assert N & (N - 1) == 0
    bits = N.bit_length() - 1
    g = GENERATORS[p]
    psi = pow(g, (p - 1) // (2 * N), p)
    assert pow(psi, 2 * N, p) == 1 and pow(psi, N, p) == p - 1
    ipsi = pow(psi, -1, p)

    psi_br = np.zeros(N, dtype=np.uint32)
    ipsi_br = np.zeros(N, dtype=np.uint32)
    for i in range(N):
        r = _bit_reverse(i, bits)
        psi_br[i] = pow(psi, r, p)
        ipsi_br[i] = pow(ipsi, r, p)
    n_inv = pow(N, -1, p)
    ipsi1_ninv = (int(ipsi_br[1]) * n_inv) % p

    def sh(x):
        return shoup(np.asarray(x, dtype=np.uint32), p)

    return dict(
        psi_br=psi_br, psi_br_shoup=sh(psi_br),
        ipsi_br=ipsi_br, ipsi_br_shoup=sh(ipsi_br),
        n_inv=np.uint32(n_inv), n_inv_shoup=sh(np.array([n_inv]))[0],
        ipsi1_ninv=np.uint32(ipsi1_ninv), ipsi1_ninv_shoup=sh(np.array([ipsi1_ninv]))[0],
    )


def ntt_forward_np(x: np.ndarray, N: int, p: int) -> np.ndarray:
    """Numpy forward NTT: uint64 in [0,p) [..., N] natural order ->
    uint32 [..., N] bit-reversed order. Exact (uint64 modmuls)."""
    psi = ntt_tables(N, p)["psi_br"].astype(np.uint64)
    x = np.ascontiguousarray(x, np.uint64)
    batch = x.shape[:-1]
    m = 1
    while m < N:
        xr = x.reshape(batch + (m, 2, N // (2 * m)))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        s = psi[m:2 * m].reshape((1,) * len(batch) + (m, 1))
        wv = (v * s) % p
        x = np.stack([(u + wv) % p, (u - wv + p) % p], axis=-2).reshape(batch + (N,))
        m *= 2
    return x.astype(np.uint32)


def i32_to_residue_np(x: np.ndarray, p: int) -> np.ndarray:
    """Signed int32 -> uint64 residue in [0, p)."""
    return (np.asarray(x).astype(np.int64) % p).astype(np.uint64)


# --------------------------------------------------------------------------
# plain-torch transforms (int64 residues in [0, p))
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _torch_table(N: int, p: int, name: str, device: str) -> torch.Tensor:
    return torch.from_numpy(ntt_tables(N, p)[name].astype(np.int64)).to(device)


def _fwd(x: torch.Tensor, N: int, p: int, axis: int) -> torch.Tensor:
    """Forward stages along `axis` (-1 or -2) of an int64 tensor."""
    psi = _torch_table(N, p, "psi_br", str(x.device))
    tail = x.shape[len(x.shape) + axis + 1:]
    lead = x.shape[:len(x.shape) + axis]
    m, t = 1, N
    while m < N:
        t //= 2
        xr = x.reshape(lead + (m, 2, t) + tail)
        u = xr[..., 0, :, :] if tail else xr[..., 0, :]
        v = xr[..., 1, :, :] if tail else xr[..., 1, :]
        s = psi[m:2 * m].reshape((m,) + (1,) * (1 + len(tail)))
        wv = (v * s) % p
        x = torch.stack([(u + wv) % p, (u - wv) % p], dim=-2 - len(tail))
        x = x.reshape(lead + (N,) + tail)
        m *= 2
    return x


def _inv(x: torch.Tensor, N: int, p: int, axis: int) -> torch.Tensor:
    """Inverse stages along `axis` (-1 or -2), output natural order, scaled by N^-1."""
    tabs = ntt_tables(N, p)
    ipsi = _torch_table(N, p, "ipsi_br", str(x.device))
    tail = x.shape[len(x.shape) + axis + 1:]
    lead = x.shape[:len(x.shape) + axis]
    t, m = 1, N
    while m > 2:
        h = m // 2
        xr = x.reshape(lead + (h, 2, t) + tail)
        u = xr[..., 0, :, :] if tail else xr[..., 0, :]
        v = xr[..., 1, :, :] if tail else xr[..., 1, :]
        s = ipsi[h:2 * h].reshape((h,) + (1,) * (1 + len(tail)))
        x = torch.stack([(u + v) % p, ((u - v) % p * s) % p], dim=-2 - len(tail))
        x = x.reshape(lead + (N,) + tail)
        t *= 2
        m = h
    xr = x.reshape(lead + (2, N // 2) + tail)
    u = xr[..., 0, :, :] if tail else xr[..., 0, :]
    v = xr[..., 1, :, :] if tail else xr[..., 1, :]
    lo = (u + v) % p * int(tabs["n_inv"]) % p
    hi = (u - v) % p * int(tabs["ipsi1_ninv"]) % p
    return torch.cat([lo, hi], dim=axis)


def ntt_forward(x: torch.Tensor, N: int, p: int) -> torch.Tensor:
    """Negacyclic forward NTT mod p. int64 [..., N] in [0,p), natural order ->
    int64 [..., N] in [0,p), bit-reversed order (matching ntt_inverse)."""
    return _fwd(x, N, p, -1)


def ntt_inverse(x: torch.Tensor, N: int, p: int) -> torch.Tensor:
    """Negacyclic inverse NTT mod p: input bit-reversed [..., N], output natural,
    scaled by N^-1 (the exact inverse of ntt_forward)."""
    return _inv(x, N, p, -1)


def ntt_forward_rows(x: torch.Tensor, N: int, p: int) -> torch.Tensor:
    """Forward NTT along axis -2 of int64 [..., N, L]; output bit-reversed along -2."""
    return _fwd(x, N, p, -2)


def ntt_inverse_rows(x: torch.Tensor, N: int, p: int) -> torch.Tensor:
    """Inverse of ntt_forward_rows (input bit-reversed along -2, output natural)."""
    return _inv(x, N, p, -2)


# --------------------------------------------------------------------------
# CRT recombination to Torus32
# --------------------------------------------------------------------------

_INV_P1_MOD_P2 = pow(P1, -1, P2)
_M_MOD_2_32 = (P1 * P2) & 0xFFFFFFFF
_T_HALF = (P2 - 1) // 2
_R1_HALF = (P1 + 1) // 2
_INV_P1_SHOUP = int((_INV_P1_MOD_P2 << 32) // P2)


def crt_to_i32(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Exact CRT lift (r1 mod P1, r2 mod P2) -> signed value mod 2^32 (int32).

    Valid for |true value| < P1*P2/2 (~2^58.5). Garner: v = r1 + P1 * t with
    t = (r2 - r1) * P1^-1 mod P2; subtract P1*P2 when v lies in the upper half
    (the same exact comparison as ``tfhe_tpu.ntt.crt_to_i32``)."""
    t = (r2 - r1 % P2) % P2 * _INV_P1_MOD_P2 % P2
    upper = (t > _T_HALF) | ((t == _T_HALF) & (r1 >= _R1_HALF))
    v = r1 + P1 * t - (P1 * P2) * upper.to(torch.int64)
    return wrap_i32(v)


def negacyclic_polymul_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product of int32 polynomials mod 2^32 (wrap), [..., N].

    `a` coefficients must be small ints (|a| < 2^20) so products fit the CRT
    range; that holds for every TFHE use (decomposed or key polynomials times
    torus polynomials). Broadcasts over leading axes."""
    N = a.shape[-1]
    residues = []
    for p in PRIMES:
        fa = ntt_forward(a.to(torch.int64) % p, N, p)
        fb = ntt_forward(b.to(torch.int64) % p, N, p)
        residues.append(ntt_inverse(fa * fb % p, N, p))
    return crt_to_i32(residues[0], residues[1])
