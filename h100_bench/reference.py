"""The plain reference: TFHE gate bootstrapping and the plaintext meaning of
every answer, in plain torch, importing nothing of the program.

A gate is the affine combination (0, const) + ca*x + cb*y of its two inputs,
then one bootstrap (`tfhe_bootstrap_FFT` of the reference library,
lwe-bootstrapping-functions-fft.cu:1884): the mod switch of the sample to
Z_{2N}, the test vector X^{-b} * (mu, ..., mu), n CMux steps of the blind
rotate (rotate, gadget decomposition, external product with the TGSW key),
the sample extract of coefficient 0 and the key switch back to the LWE key.
Every step is exact integer arithmetic mod 2^32, so the program's samples
must equal these word for word.

The external product is a matrix product in float64: the decomposed digits
[R, kpl*N] times the negacyclic matrices of one step's key [kpl*N, (k+1)*N].
Every partial sum is an integer below 2^52 in magnitude (digits below 2^9,
key words below 2^31, 2^12 terms), so float64 holds it exactly. The same
product in float32 (``dtype=torch.float32``, TF32 off) is the control: the
nearest precision below, which rounds the key words and the sums.
"""
from __future__ import annotations

import numpy as np
import torch

from keys import MU, RawKeys, negacyclic_index, wrap32

# gate -> (constant, coefficient of x, coefficient of y) and its truth table
# (the reference's boot-gates.cu:98-448; constants in units of 1/8)
GATES = {
    "NAND": (+1, -1, -1), "OR": (+1, +1, +1), "AND": (-1, +1, +1),
    "XOR": (+2, +2, +2), "XNOR": (-2, -2, -2), "NOR": (-1, -1, -1),
    "ANDNY": (-1, -1, +1), "ANDYN": (-1, +1, -1), "ORNY": (+1, -1, +1), "ORYN": (+1, +1, -1),
}
TRUTH = {
    "NAND": lambda x, y: 1 - (x & y), "OR": lambda x, y: x | y, "AND": lambda x, y: x & y,
    "XOR": lambda x, y: x ^ y, "XNOR": lambda x, y: 1 - (x ^ y), "NOR": lambda x, y: 1 - (x | y),
    "ANDNY": lambda x, y: (1 - x) & y, "ANDYN": lambda x, y: x & (1 - y),
    "ORNY": lambda x, y: (1 - x) | y, "ORYN": lambda x, y: x | (1 - y),
}


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def mod_switch(x: torch.Tensor, N: int) -> torch.Tensor:
    """round(x * 2N / 2^32) mod 2N (numeric-functions.cu:60-67)."""
    shift = 32 - (2 * N).bit_length() + 1
    return ((_u32(x) + (1 << (shift - 1))) >> shift) & (2 * N - 1)


def rotate(x: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount * x in Z[X]/(X^N + 1): x int64[R, C, N], amount [R] in [0, 2N)."""
    N = x.shape[-1]
    m = torch.arange(N, device=x.device)
    src = (m[None, :] - amount[:, None]) % (2 * N)
    neg = src >= N
    take = torch.gather(x, 2, (src - N * neg)[:, None, :].expand(x.shape))
    return torch.where(neg[:, None, :], -take, take)


def decompose(x: torch.Tensor, keys: RawKeys) -> torch.Tensor:
    """Signed digits in [-Bg/2, Bg/2) of x int64[R, k+1, N] mod 2^32:
    [R, (k+1)*l, N], row c*l + level (tgsw-functions.cu:296-340)."""
    p = keys.params
    Bg = 1 << p.bk_Bgbit
    offset = sum(1 << (32 - (i + 1) * p.bk_Bgbit) for i in range(p.bk_l)) * (Bg // 2)
    u = (_u32(x) + offset) & 0xFFFFFFFF
    digs = [((u >> (32 - (i + 1) * p.bk_Bgbit)) & (Bg - 1)) - Bg // 2 for i in range(p.bk_l)]
    return torch.stack(digs, dim=2).reshape(x.shape[0], p.kpl, p.N)


def blind_rotate(keys: RawKeys, acc: torch.Tensor, bara: torch.Tensor,
                 dtype=torch.float64) -> torch.Tensor:
    """The n CMux steps: acc int64[R, k+1, N] (values mod 2^32), bara [R, n]."""
    p = keys.params
    idx, sign = negacyclic_index(p.N, acc.device)
    sign = sign.to(dtype)
    for i in range(p.n):
        rot = rotate(acc, bara[:, i])
        dec = decompose(rot - acc, keys).reshape(acc.shape[0], p.kpl * p.N).to(dtype)
        kmat = keys.bk[i].to(dtype)[..., idx] * sign           # [kpl, k+1, N(j), N(m)]
        kmat = kmat.permute(0, 2, 1, 3).reshape(p.kpl * p.N, (p.k + 1) * p.N)
        delta = torch.round(dec @ kmat).to(torch.int64)
        acc = _u32(acc + delta.reshape(acc.shape))
    return acc


def sample_extract(acc: torch.Tensor, k: int):
    """Coefficient 0 as an LWE sample over the extracted key (lwe.cu:40-56)."""
    R, _, N = acc.shape
    a = torch.cat([acc[:, :k, :1], -torch.flip(acc[:, :k, 1:], dims=(-1,))], dim=-1)
    return a.reshape(R, k * N), acc[:, k, 0]


def key_switch(keys: RawKeys, a_ext: torch.Tensor, b_ext: torch.Tensor,
               dtype=torch.float64, rows: int = 1024):
    """(0, b) - sum_{i,j} ks[i][j][digit_ij] over the base-2^basebit digits of
    the rounded a_ext (lwe-keyswitch-functions.cu:101-127), as the product of
    the 0/1 digit indicators [R, n_ext*t*(base-1)] with the key's rows: at
    most n_ext*t words below 2^31 a sum, exact in float64."""
    p = keys.params
    prec = 1 << (32 - (1 + p.ks_basebit * p.ks_t))
    shifts = torch.tensor([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)],
                          device=a_ext.device)
    hv = torch.arange(1, p.ks_base, device=a_ext.device)
    table = torch.cat([keys.ks_a[:, :, 1:, :], keys.ks_b[:, :, 1:, None]], dim=-1)
    table = table.reshape(-1, p.n + 1).to(dtype)
    sums = []
    for s in range(0, a_ext.shape[0], rows):
        aibar = (_u32(a_ext[s:s + rows]) + prec) & 0xFFFFFFFF
        digit = (aibar[..., None] >> shifts) & (p.ks_base - 1)        # [r, n_ext, t]
        onehot = (digit[..., None] == hv).reshape(digit.shape[0], -1).to(dtype)
        sums.append(torch.round(onehot @ table).to(torch.int64))
    r = torch.cat(sums)
    return wrap32(-r[:, :p.n]), wrap32(b_ext - r[:, p.n])


def rotate_extract(keys: RawKeys, a: torch.Tensor, b: torch.Tensor, mu=MU,
                   dtype=torch.float64, rows: int = 4096):
    """Mod switch, test vector, blind rotate and sample extract of LWE samples
    (a int32[R, n], b int32[R]) with output amplitude mu (an int, or int32[R]
    with one for each sample), `rows` samples at a time: (a_ext int64[R, k*N],
    b_ext int64[R]), values mod 2^32."""
    p = keys.params
    outs_a, outs_b = [], []
    for s in range(0, b.shape[0], rows):
        bs, as_ = b[s:s + rows], a[s:s + rows]
        R = bs.shape[0]
        mu_r = (mu[s:s + rows].to(torch.int64) if isinstance(mu, torch.Tensor) and mu.dim()
                else torch.full((R,), int(mu), dtype=torch.int64, device=b.device))
        barb = mod_switch(bs, p.N)
        bara = mod_switch(as_, p.N)
        tv = mu_r[:, None, None].expand(R, 1, p.N).contiguous()
        tv = _u32(rotate(tv, (2 * p.N - barb) % (2 * p.N)))
        acc = torch.cat([torch.zeros((R, p.k, p.N), dtype=torch.int64, device=b.device), tv],
                        dim=1)
        acc = blind_rotate(keys, acc, bara, dtype)
        a_ext, b_ext = sample_extract(acc, p.k)
        outs_a.append(a_ext)
        outs_b.append(b_ext)
    return torch.cat(outs_a), torch.cat(outs_b)


def bootstrap(keys: RawKeys, a: torch.Tensor, b: torch.Tensor, mu=MU,
              dtype=torch.float64):
    """The gate bootstrap of LWE samples (a int32[R, n], b int32[R]) to
    amplitude mu: (a int32[R, n], b int32[R])."""
    a_ext, b_ext = rotate_extract(keys, a, b, mu, dtype)
    return key_switch(keys, a_ext, b_ext, dtype)


def affine(kind: str, xa, xb, ya, yb):
    """The gate's affine stage (0, const) + ca*x + cb*y, int32 mod 2^32."""
    const, ca, cb = GATES[kind]
    a = wrap32(ca * xa.to(torch.int64) + cb * ya.to(torch.int64))
    b = wrap32(const * MU + ca * xb.to(torch.int64) + cb * yb.to(torch.int64))
    return a, b


def gate(keys: RawKeys, kind: str, xa, xb, ya, yb, dtype=torch.float64):
    """A bootstrapped two-input gate on rows of samples."""
    return bootstrap(keys, *affine(kind, xa, xb, ya, yb), dtype=dtype)


# ---------------------------------------------------------------- plaintext

def wrap_int(v, nbits: int):
    """Two's-complement value of v mod 2^nbits."""
    v = np.asarray(v, np.int64) & ((1 << nbits) - 1)
    return v - ((v >> (nbits - 1)) << nbits)


def cipher_op(op: str, a: int, b: int, nbits: int) -> int:
    """What a CipherInt operation means on plaintext integers: two's
    complement with wrap; > and eq give 0/1; minimum compares unsigned (its
    operands are non-negative); / truncates towards zero (divisor nonzero)."""
    if op == "add":
        r = a + b
    elif op == "sub":
        r = a - b
    elif op == "mul":
        r = a * b
    elif op == "gt":
        return int(a > b)
    elif op == "eq":
        return int(a == b)
    elif op == "abs":
        r = abs(a)
    elif op == "min":
        r = min(a & ((1 << nbits) - 1), b & ((1 << nbits) - 1))
    elif op == "div":
        q = abs(a) // abs(b)
        r = -q if (a < 0) != (b < 0) else q
    else:
        raise ValueError(f"unknown op {op!r}")
    return int(wrap_int(r, nbits))


def matmul(a: np.ndarray, b: np.ndarray, nbits: int) -> np.ndarray:
    """The product of integer matrices, each element wrapped to nbits."""
    return wrap_int(a.astype(np.int64) @ b.astype(np.int64), nbits)


def int_bits(values, nbits: int) -> np.ndarray:
    """LSB-first bits of two's-complement integers: [..., nbits]."""
    v = np.asarray(values, np.int64)
    return ((v[..., None] >> np.arange(nbits)) & 1).astype(np.int32)


def bits_int(bits: np.ndarray, signed: bool = True) -> np.ndarray:
    bits = np.asarray(bits, np.int64)
    nbits = bits.shape[-1]
    v = (bits << np.arange(nbits)).sum(-1)
    return v - (bits[..., -1] << nbits) if signed else v
