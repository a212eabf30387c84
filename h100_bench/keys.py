"""Keys and ciphertexts made from the seed, in plain torch on the run's device.

The benchmark makes its own inputs: the secret keys, the raw bootstrapping
key and key-switch key (the TFHE key generation of the reference library,
`lwe-bootstrapping-functions.cu:185-229` and
`lwe-keyswitch-functions.cu:886-938`), and the encryptions of the plaintext
bits. The raw keys go to the program through its own set-up
(``tfhe_tpu_torch.core.keys.cloud_from_raw``) and, unchanged, to the plain
reference. Nothing here imports the program.

Torus32 values are int32 tensors read modulo 2^32. Sums of products are taken
in float64, which is exact while every partial sum stays under 2^53: a key
bit times a Torus32 value summed over at most 2^21 terms.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

MU = 1 << 29                     # the amplitude of a boolean message: 1/8 of the torus


@dataclass(frozen=True)
class Params:
    """The TFHE parameter set of a configuration (its ``params`` group)."""
    n: int
    N: int
    k: int
    bk_l: int
    bk_Bgbit: int
    ks_basebit: int
    ks_t: int
    ks_stdev: float
    bk_stdev: float

    @property
    def kpl(self) -> int:
        return (self.k + 1) * self.bk_l

    @property
    def n_extract(self) -> int:
        return self.k * self.N

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit


@dataclass
class RawKeys:
    """Secret keys and the raw evaluation keys, as int32 tensors."""
    params: Params
    lwe_key: torch.Tensor        # [n] in {0, 1}
    tlwe_key: torch.Tensor       # [k, N] in {0, 1}
    bk: torch.Tensor             # [n, kpl, k+1, N]: TGSW encryptions of the LWE key bits
    ks_a: torch.Tensor           # [n_ext, t, base, n]
    ks_b: torch.Tensor           # [n_ext, t, base]


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor (int64, or float64 holding integers) mod 2^32, as int32."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def generator(seed, device, stream: str) -> torch.Generator:
    """A generator on `device` for one named stream of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def uniform32(shape, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=g, dtype=torch.int32,
                         device=device)


def gaussian32(shape, sigma: float, g: torch.Generator, device) -> torch.Tensor:
    """Torus32 noise of standard deviation sigma (a fraction of the torus)."""
    if sigma == 0.0:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    e = torch.randn(shape, generator=g, dtype=torch.float64, device=device) * sigma
    return wrap32(torch.round(e * 2.0 ** 32))


def negacyclic_index(N: int, device):
    """(index, sign) of the negacyclic matrix: (d * p)[m] = sum_j d[j] * M[j, m]
    with M[j, m] = sign[j, m] * p[index[j, m]]."""
    j = torch.arange(N, device=device)[:, None]
    m = torch.arange(N, device=device)[None, :]
    return (m - j) % N, torch.where(m >= j, 1.0, -1.0).to(torch.float64)


def negacyclic_matrices(p: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """p: [..., N] -> [..., N, N], the matrix of multiplication by p in
    Z[X]/(X^N + 1), in `dtype`."""
    N = p.shape[-1]
    idx, sign = negacyclic_index(N, p.device)
    return p.to(dtype)[..., idx] * sign.to(dtype)


def lwe_dot(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_i a[..., i] * key[i] mod 2^32 for a binary key, exact, in blocks."""
    flat = a.reshape(-1, a.shape[-1])
    k64 = key.to(torch.float64)
    out = torch.empty(flat.shape[0], dtype=torch.int32, device=a.device)
    step = 1 << 16
    for s in range(0, flat.shape[0], step):
        out[s:s + step] = wrap32(flat[s:s + step].to(torch.float64) @ k64)
    return out.reshape(a.shape[:-1])


def keygen(params: Params, seed, device) -> RawKeys:
    """The secret keys and the raw bootstrapping and key-switch keys from the seed."""
    p = params
    g = generator(seed, device, "keys")
    lwe_key = torch.randint(0, 2, (p.n,), generator=g, dtype=torch.int32, device=device)
    tlwe_key = torch.randint(0, 2, (p.k, p.N), generator=g, dtype=torch.int32, device=device)

    # bootstrapping key: for each LWE key bit, kpl TLWE encryptions of zero
    # (b = e + sum_j s_j * a_j), plus bit * h[row] on the block diagonal
    a = uniform32((p.n, p.kpl, p.k, p.N), g, device)
    e = gaussian32((p.n, p.kpl, p.N), p.bk_stdev, g, device)
    s_mat = negacyclic_matrices(tlwe_key)                        # [k, N, N]
    prods = torch.einsum("rkj,kjm->rm", a.reshape(-1, p.k, p.N).to(torch.float64), s_mat)
    b = wrap32(e.reshape(-1, p.N).to(torch.int64) + prods.to(torch.int64))
    bk = torch.cat([a, b.reshape(p.n, p.kpl, 1, p.N)], dim=2)
    for c in range(p.k + 1):
        for lvl in range(p.bk_l):
            h = 1 << (32 - (lvl + 1) * p.bk_Bgbit)
            bk[:, c * p.bk_l + lvl, c, 0] = wrap32(bk[:, c * p.bk_l + lvl, c, 0].to(torch.int64)
                                                    + lwe_key.to(torch.int64) * h)

    # key-switch key: row (i, j, h) encrypts ext_key[i] * h / base^(j+1) under
    # the LWE key; the h = 0 rows are zero
    n_ext, t, base = p.n_extract, p.ks_t, p.ks_base
    rows = n_ext * t * (base - 1)
    ka = uniform32((rows, p.n), g, device)
    ke = gaussian32((rows,), p.ks_stdev, g, device)
    ext_key = tlwe_key.reshape(n_ext).to(torch.int64)
    hv = torch.arange(1, base, dtype=torch.int64, device=device)
    shift = torch.tensor([1 << (32 - (j + 1) * p.ks_basebit) for j in range(t)],
                         dtype=torch.int64, device=device)
    msg = (ext_key[:, None, None] * hv[None, None, :] * shift[None, :, None]).reshape(rows)
    kb = wrap32(msg + ke.to(torch.int64) + lwe_dot(ka, lwe_key).to(torch.int64))
    ks_a = torch.zeros((n_ext, t, base, p.n), dtype=torch.int32, device=device)
    ks_b = torch.zeros((n_ext, t, base), dtype=torch.int32, device=device)
    ks_a[:, :, 1:] = ka.reshape(n_ext, t, base - 1, p.n)
    ks_b[:, :, 1:] = kb.reshape(n_ext, t, base - 1)
    return RawKeys(p, lwe_key, tlwe_key, bk, ks_a, ks_b)


def encrypt_bits(keys: RawKeys, bits: torch.Tensor, g: torch.Generator):
    """Encryptions of boolean messages (+1/8 for 1, -1/8 for 0) under the LWE
    key, with the key-switch noise: (a int32[..., n], b int32[...],
    cv float32[...])."""
    p = keys.params
    dev = keys.lwe_key.device
    bits = bits.to(dev)
    a = uniform32(tuple(bits.shape) + (p.n,), g, dev)
    e = gaussian32(tuple(bits.shape), p.ks_stdev, g, dev)
    mu = torch.where(bits != 0, MU, -MU).to(torch.int64)
    b = wrap32(mu + e.to(torch.int64) + lwe_dot(a, keys.lwe_key).to(torch.int64))
    cv = torch.full(tuple(bits.shape), p.ks_stdev ** 2, dtype=torch.float32, device=dev)
    return a, b, cv


def phase(keys: RawKeys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - a.s mod 2^32, int32."""
    return wrap32(b.to(torch.int64) - lwe_dot(a, keys.lwe_key).to(torch.int64))


def decrypt_bits(keys: RawKeys, a: torch.Tensor, b: torch.Tensor):
    """(bits, margin): bit 1 where the phase is positive; margin = |phase -
    (+-1/8)| / (1/8), the distance from the ideal message in units of 1/8."""
    ph = phase(keys, a, b).to(torch.int64)
    bits = (ph > 0).to(torch.int32)
    ideal = torch.where(ph > 0, MU, -MU)
    return bits, (ph - ideal).abs().to(torch.float64) / MU
