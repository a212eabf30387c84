"""Key generation and the cloud-key layouts, on numpy and torch.

Port of ``tfhe_tpu.core.keys``. ``cloud_from_raw`` is the weights carry-over:
from the same numpy raw keys (``bk_raw``, ``ks_a``, ``ks_b``) it builds the
same arrays as the JAX ``CloudKey``, byte for byte, as tensors on a device:

- ``bk_ntt``/``bk_ntt_shoup``: the bootstrapping key in NTT domain per CRT
  prime with its Shoup twin, uint32[n, P, kpl, k+1, N];
- ``bk_rows``/``bk_rows_shoup``: the same per coefficient, uint32[n, P, N,
  kpl*(k+1)], the layout the blind-rotate kernels stream;
- ``ks_table``: the key-switch key as int8 limb planes [n_ext*t*(base-1),
  4*pad_cols] for the one-hot matmul key switch;
- ``ks_table_perm``: the same rows regrouped to native accumulator order,
  int8[t*(base-1), n_ext, 4*pad_cols], for the fused key-switch kernel.

``keygen`` draws from a seeded ``torch.Generator`` (any parameter set; it
cannot match jax threefry draw for draw, so it is checked by decryption);
``keygen_reference`` gives the reference's own keys at PARAMS_110.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..params import TfheParams
from .. import ntt
from ..numeric import dtot32, resolve_device, uniform_torus32, wrap_i32


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class CloudKey:
    """Evaluation keys: tensors of key material on one device (no autograd)."""
    params: TfheParams
    bk_ntt: torch.Tensor          # uint32[n, P, kpl, k+1, N]
    bk_ntt_shoup: torch.Tensor
    bk_rows: torch.Tensor         # uint32[n, P, N, kpl*(k+1)]
    bk_rows_shoup: torch.Tensor
    ks_table: torch.Tensor        # int8[n_ext*t*(base-1), 4*pad_cols]
    ks_table_perm: torch.Tensor   # int8[t*(base-1), n_ext, 4*pad_cols]

    def to(self, device) -> "CloudKey":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "params"})


@dataclass
class SecretKeySet:
    """Secret keys and host-side raw key material (numpy), plus the cloud key."""
    params: TfheParams
    lwe_key: np.ndarray          # int32[n] in {0,1}
    tlwe_key: np.ndarray         # int32[k, N] in {0,1}
    bk_raw: np.ndarray           # int32[n, kpl, k+1, N]
    ks_a: np.ndarray             # int32[n_ext, t, base, n]
    ks_b: np.ndarray             # int32[n_ext, t, base]
    cloud: CloudKey
    seed: Any = None


# ------------------------------------------------------------ numpy layouts

def ks_perm_rows(ks_table: np.ndarray, params: TfheParams) -> np.ndarray:
    """Regroup the KS limb table for the fused key switch.

    ks_table rows are (i, j, h-1) C-order over EXTRACTED coefficients i. The
    fused kernel reads the accumulator directly, so rows are regrouped as
    (j, h-1) planes over NATIVE coefficients m (the sample-extract index map
    i = 0 if m == 0 else N-m, ref lwe.cu:40-56, folds into the table).

    [rows, 4*C] -> [t*(base-1), n_ext, 4, C].
    """
    n_ext, t, bm1 = params.n_extract, params.ks_t, params.ks_base - 1
    C = ks_table.shape[1] // 4
    tab = ks_table.reshape(n_ext, t, bm1, 4, C)
    m = np.arange(n_ext)
    i_of_m = np.where(m == 0, 0, n_ext - m)
    return tab[i_of_m].transpose(1, 2, 0, 3, 4).reshape(t * bm1, n_ext, 4, C)


def bk_rows_layout(bk_ntt: np.ndarray) -> np.ndarray:
    """[n, P, kpl, k+1, N] -> [n, P, N, kpl*(k+1)]."""
    n, P, kpl, k1, N = bk_ntt.shape
    return np.ascontiguousarray(
        bk_ntt.transpose(0, 1, 4, 2, 3).reshape(n, P, N, kpl * k1))


def bk_to_ntt_np(bk_raw: np.ndarray, params: TfheParams):
    """BK -> NTT domain per prime, with the Shoup twin (numpy, exact)."""
    outs, shoups = [], []
    for p in ntt.PRIMES:
        f = ntt.ntt_forward_np(ntt.i32_to_residue_np(bk_raw, p), params.N, p)
        outs.append(f)
        shoups.append(ntt.shoup(f, p))
    return np.stack(outs, axis=1), np.stack(shoups, axis=1)


def ks_to_limb_table(ks_a: np.ndarray, ks_b: np.ndarray, params: TfheParams) -> np.ndarray:
    """Pack the KS key into the int8 limb-plane matmul table.

    Rows: (i, j, h-1) C-order, h in [1, base). Columns: 4 limb planes of
    [a_0..a_{n-1}, b, pad...] padded to a multiple of 128. Signed base-256
    digits with carry so that sum_l d_l * 2^(8l) == v (mod 2^32).
    """
    n = params.n
    n_ext, t, base = ks_a.shape[0], ks_a.shape[1], ks_a.shape[2]
    rows = n_ext * t * (base - 1)
    pad_cols = _pad_to(n + 1, 128)
    full = np.zeros((rows, pad_cols), np.uint32)
    full[:, :n] = ks_a[:, :, 1:, :].reshape(rows, n).view(np.uint32)
    full[:, n] = ks_b[:, :, 1:].reshape(rows).view(np.uint32)

    # bytes of v + 0x80808080, each minus 128, are signed digits d_l in
    # [-128, 127] with sum_l d_l * 2^(8l) == v (mod 2^32)
    w = full + np.uint32(0x80808080)
    limbs = np.empty((rows, 4, pad_cols), np.int8)
    for l in range(4):
        limbs[:, l, :] = (((w >> np.uint32(8 * l)) & np.uint32(255))
                          .astype(np.int16) - np.int16(128)).astype(np.int8)
    return limbs.reshape(rows, 4 * pad_cols)


def cloud_from_raw(params: TfheParams, bk_raw: np.ndarray, ks_a: np.ndarray,
                   ks_b: np.ndarray, device) -> CloudKey:
    """Build the CloudKey layouts from raw host key material on `device`
    (the same arrays as ``tfhe_tpu.core.keys.cloud_from_raw``)."""
    bk_ntt, bk_shoup = bk_to_ntt_np(np.asarray(bk_raw), params)
    ks_table = ks_to_limb_table(np.asarray(ks_a), np.asarray(ks_b), params)
    perm = ks_perm_rows(ks_table, params)
    TB, n_ext, _, C = perm.shape

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return CloudKey(
        params=params,
        bk_ntt=put(bk_ntt),
        bk_ntt_shoup=put(bk_shoup),
        bk_rows=put(bk_rows_layout(bk_ntt)),
        bk_rows_shoup=put(bk_rows_layout(bk_shoup)),
        ks_table=put(ks_table),
        ks_table_perm=put(perm.reshape(TB, n_ext, 4 * C)),
    )


# ------------------------------------------------------------ torch keygen

def generate_bootstrapping_key(generator: torch.Generator, lwe_key: torch.Tensor,
                               tlwe_key: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """TGSW encryptions of each LWE key bit (ref lwe-bootstrapping-functions.cu:185-229).

    Returns int32[n, kpl, k+1, N] on the keys' device."""
    n, N, k, l, kpl = params.n, params.N, params.k, params.bk_l, params.kpl
    dev = lwe_key.device
    a = uniform_torus32((n, kpl, k, N), generator, dev)
    noise = torch.zeros((n, kpl, N), dtype=torch.int32, device=dev)
    if params.bk_stdev > 0.0:
        noise = dtot32(torch.randn((n, kpl, N), generator=generator, device=dev)
                       * params.bk_stdev)
    # b = noise + sum_j s_j (x) a_j   (tLweSymEncryptZero, tlwe-functions.cu:26-39)
    prods = ntt.negacyclic_polymul_i32(tlwe_key[None, None], a)    # [n, kpl, k, N]
    b = wrap_i32(noise.to(torch.int64) + prods.to(torch.int64).sum(2))
    bk = torch.cat([a, b[:, :, None, :]], dim=2)                   # [n, kpl, k+1, N]
    # message * H on the block diagonal (tGswAddMuIntH, tgsw-functions.cu:114-123)
    for bloc in range(k + 1):
        for p in range(l):
            bk[:, bloc * l + p, bloc, 0] += lwe_key * params.h[p]
    return bk


def generate_keyswitch_key(generator: torch.Generator, ext_key: torch.Tensor,
                           lwe_key: torch.Tensor, params: TfheParams):
    """Key-switch key from the extracted key to the LWE key
    (ref lweCreateKeySwitchKey, lwe-keyswitch-functions.cu:886-938).

    Returns (ks_a int32[n_ext, t, base, n], ks_b int32[n_ext, t, base])."""
    n, n_ext, t, basebit = params.n, params.n_extract, params.ks_t, params.ks_basebit
    base = params.ks_base
    sizeks = n_ext * t * (base - 1)
    dev = lwe_key.device
    noise = torch.zeros(sizeks, dtype=torch.int32, device=dev)
    if params.ks_stdev > 0.0:
        f = torch.randn(sizeks, generator=generator, device=dev) * params.ks_stdev
        noise = dtot32(f - f.mean())                       # recentred (ref :897-906)
    a = uniform_torus32((sizeks, n), generator, dev)
    # message for row (i, j, h): ext_key[i] * h * 2^(32-(j+1)*basebit)
    hvals = torch.arange(1, base, dtype=torch.int64, device=dev)
    shifts = torch.tensor([1 << (32 - (j + 1) * basebit) for j in range(t)],
                          dtype=torch.int64, device=dev)
    mess = (ext_key.to(torch.int64)[:, None, None] * hvals[None, None, :]
            * shifts[None, :, None]).reshape(sizeks)
    b = wrap_i32(mess + noise + (a.to(torch.int64) * lwe_key.to(torch.int64)).sum(1))
    a = a.reshape(n_ext, t, base - 1, n)
    b = b.reshape(n_ext, t, base - 1)
    # prepend the unused trivial h=0 row (ref :915)
    ks_a = torch.cat([torch.zeros((n_ext, t, 1, n), dtype=torch.int32, device=dev), a], 2)
    ks_b = torch.cat([torch.zeros((n_ext, t, 1), dtype=torch.int32, device=dev), b], 2)
    return ks_a, ks_b


def _seed_int(seed) -> int:
    """A seed (int or tuple of ints) as one 63-bit generator seed."""
    seed = tuple(seed) if isinstance(seed, (tuple, list)) else (seed,)
    digest = hashlib.sha256(repr(tuple(int(s) for s in seed)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def keygen(params: TfheParams, seed=(314, 1592, 657), device=None) -> SecretKeySet:
    """Generate a secret keyset and its cloud key on `device` (the card when
    None; ``device="cpu"`` for the CPU) from a seeded torch.Generator
    (ref tfhe_gate_bootstrapping.cu:57-70)."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_seed_int(seed))
    lwe_key = torch.randint(0, 2, (params.n,), generator=g, dtype=torch.int32, device=device)
    tlwe_key = torch.randint(0, 2, (params.k, params.N), generator=g, dtype=torch.int32,
                             device=device)
    bk_raw = generate_bootstrapping_key(g, lwe_key, tlwe_key, params)
    ks_a, ks_b = generate_keyswitch_key(g, tlwe_key.reshape(params.n_extract), lwe_key,
                                        params)
    lwe_key, tlwe_key, bk_raw, ks_a, ks_b = (
        v.cpu().numpy() for v in (lwe_key, tlwe_key, bk_raw, ks_a, ks_b))
    return SecretKeySet(params=params, lwe_key=lwe_key, tlwe_key=tlwe_key,
                        bk_raw=bk_raw, ks_a=ks_a, ks_b=ks_b,
                        cloud=cloud_from_raw(params, bk_raw, ks_a, ks_b, device),
                        seed=seed)


def keygen_reference(params: TfheParams, seed=(314, 1592, 657), device=None) -> SecretKeySet:
    """Keygen with the reference's exact PRNG (native C++, no torch draws);
    the cloud key goes to `device` (the card when None).

    Keys are byte-identical to the reference binaries' and to
    ``tfhe_tpu.core.keys.keygen_reference`` for the same seed."""
    from .. import ref_keygen

    device = resolve_device(device)
    if not ref_keygen.params_match_reference(params):
        raise ValueError("reference-PRNG keygen only exists for the reference parameter set")
    lwe_key, tlwe_key, ks_a, ks_b, bk_raw = ref_keygen.keygen_raw(seed)
    return SecretKeySet(params=params, lwe_key=lwe_key, tlwe_key=tlwe_key, bk_raw=bk_raw,
                        ks_a=ks_a, ks_b=ks_b,
                        cloud=cloud_from_raw(params, bk_raw, ks_a, ks_b, device),
                        seed=seed)
