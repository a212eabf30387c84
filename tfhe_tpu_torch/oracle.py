"""Pure-NumPy exact TFHE oracle for differential testing.

A copy of ``tfhe_tpu.oracle`` for the port, which imports nothing of
``tfhe_tpu``. It mirrors, operation by operation and one sample at a time,
the reference CPU implementation (`gpuParallel/*.cu` original CPU paths and
`cpuParallel/`) with exact int64 integer arithmetic instead of FFTs, so every
stage of the port's pipeline (exact 2-prime CRT-NTT) must equal it bit for
bit.

Not performance-relevant; never used on the hot path.
"""
from __future__ import annotations

import numpy as np

from .params import TfheParams

I32 = np.int32
U32 = np.uint32


def _wrap32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64).astype(np.uint32).astype(np.int32)


# ---------------------------------------------------------------- numerics

def mod_switch_from_torus32(phase, Msize: int):
    """ref numeric-functions.cu:60-67."""
    phase64 = (np.asarray(phase).astype(np.int64).astype(np.uint64) << np.uint64(32))
    interv = np.uint64(((1 << 63) // Msize) * 2)
    phase64 = phase64 + interv // np.uint64(2)
    return (phase64 // interv).astype(np.int64).astype(np.int32)


def mod_switch_to_torus32(mu, Msize: int) -> np.int32:
    """ref numeric-functions.cu:72-78."""
    interv = ((1 << 63) // Msize) * 2
    phase64 = (int(mu) * interv) % (1 << 64)
    return np.int64(phase64 >> 32).astype(np.int32)


def approx_phase(phase, Msize: int):
    """ref numeric-functions.cu:47-56."""
    interv = np.uint64(((1 << 63) // Msize) * 2)
    half = interv // np.uint64(2)
    phase64 = (np.asarray(phase).astype(np.int64).astype(np.uint64) << np.uint64(32)) + half
    phase64 -= phase64 % interv
    return (phase64 >> np.uint64(32)).astype(np.int64).astype(np.int32)


# ---------------------------------------------------------------- polynomials

def negacyclic_polymul(a, b):
    """Exact product in Z[X]/(X^N+1) mod 2^32. a: small ints, b: torus32."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    N = a.shape[-1]
    out = np.zeros(N, np.int64)
    for i in range(N):
        ai = a[i]
        if ai == 0:
            continue
        out[i:] += ai * b[: N - i]
        out[:i] -= ai * b[N - i:]
    return _wrap32(out)


def mul_by_xai(a: int, poly):
    """X^a * poly, a in [0, 2N) (ref toruspolynomial-functions.cu:492-520)."""
    poly = np.asarray(poly, np.int32)
    N = poly.shape[-1]
    out = np.empty_like(poly)
    a = a % (2 * N)
    if a < N:
        out[:a] = _wrap32(-poly[N - a:].astype(np.int64))
        out[a:] = poly[: N - a]
    else:
        aa = a - N
        out[:aa] = poly[N - aa:]
        out[aa:] = _wrap32(-poly[: N - aa].astype(np.int64))
    return out


# ---------------------------------------------------------------- TGSW decompose

def decompose(poly, params: TfheParams):
    """Gadget decomposition of a torus polynomial -> [l, N] small ints
    (ref tgsw-functions.cu:296-...: offset trick)."""
    u = np.asarray(poly, np.int32).astype(np.uint32) + np.uint32(params.decomp_offset)
    out = np.empty((params.bk_l, poly.shape[-1]), np.int32)
    for p in range(params.bk_l):
        shift = 32 - (p + 1) * params.bk_Bgbit
        out[p] = ((u >> np.uint32(shift)) & np.uint32(params.maskMod)).astype(np.int32) - params.halfBg
    return out


# ---------------------------------------------------------------- LWE / TLWE

def lwe_phase(a, b, key):
    """phi = b - a.s (ref lwe-functions.cu:72-81), int32 wrap."""
    a = np.asarray(a, np.int32).astype(np.int64)
    s = np.asarray(key, np.int64)
    return _wrap32(np.int64(b) - np.sum(a * s))


def tlwe_phase(a_polys, b_poly, tlwe_key):
    """phi = b - sum_i a_i * s_i over the ring."""
    acc = np.asarray(b_poly, np.int32).astype(np.int64)
    for i in range(len(tlwe_key)):
        prod = negacyclic_polymul(tlwe_key[i], a_polys[i]).astype(np.int64)
        acc = acc - prod
    return _wrap32(acc)


def extern_product(acc_a, params: TfheParams, bk_sample):
    """TGSW x TLWE external product (ref tgsw-functions.cu:156-170).

    acc_a: [k+1, N] the TLWE sample (b is row k); bk_sample: [kpl, k+1, N].
    Returns new [k+1, N] (replaces the accumulator, as tGswExternMulToTLwe does).
    """
    k, l, N = params.k, params.bk_l, params.N
    dec = np.empty((params.kpl, N), np.int32)
    for i in range(k + 1):
        dec[i * l:(i + 1) * l] = decompose(acc_a[i], params)
    out = np.zeros((k + 1, N), np.int64)
    for row in range(params.kpl):
        for c in range(k + 1):
            out[c] += negacyclic_polymul(dec[row], bk_sample[row, c]).astype(np.int64)
    return _wrap32(out)


def cmux_rotate(acc, bk_sample, barai: int, params: TfheParams):
    """ACC <- BKi * [(X^barai - 1) ACC] + ACC (ref lwe-bootstrapping-functions.cu:34-44)."""
    k = params.k
    rotated = np.stack([mul_by_xai(barai, acc[c]) for c in range(k + 1)])
    diff = _wrap32(rotated.astype(np.int64) - acc.astype(np.int64))
    prod = extern_product(diff, params, bk_sample)
    return _wrap32(prod.astype(np.int64) + acc.astype(np.int64))


def blind_rotate(acc, bk, bara, params: TfheParams):
    """500-iteration CMux chain (ref lwe-bootstrapping-functions.cu:56-76)."""
    for i in range(params.n):
        if bara[i] == 0:
            continue
        acc = cmux_rotate(acc, bk[i], int(bara[i]), params)
    return acc


def sample_extract(acc, params: TfheParams):
    """Extract LWE sample at index 0 (ref lwe.cu:40-56).

    Returns (a[k*N], b). a[i*N+0] = acc_a[i][0]; a[i*N+j] = -acc_a[i][N-j] (j>0).
    """
    k, N = params.k, params.N
    a = np.empty(k * N, np.int32)
    for i in range(k):
        a[i * N] = acc[i][0]
        a[i * N + 1:(i + 1) * N] = _wrap32(-acc[i][N - 1:0:-1].astype(np.int64))
    return a, np.int32(acc[k][0])


def key_switch(a_ext, b_ext, ks_a, ks_b, params: TfheParams):
    """LWE key switch (ref lwe-keyswitch-functions.cu:101-127, 955-989).

    ks_a: [n_extract, t, base, n] int32, ks_b: [n_extract, t, base] int32
    (index 0 along base is the unused trivial sample).
    """
    n_ext, t, basebit = params.n_extract, params.ks_t, params.ks_basebit
    mask = params.ks_base - 1
    res_a = np.zeros(params.n, np.int64)
    res_b = np.int64(b_ext)
    prec_offset = np.uint32(params.ks_prec_offset)
    for i in range(n_ext):
        aibar = np.uint32(np.int64(a_ext[i]).astype(np.uint32) + prec_offset)
        for j in range(t):
            aij = int((aibar >> np.uint32(32 - (j + 1) * basebit)) & np.uint32(mask))
            if aij != 0:
                res_a -= ks_a[i, j, aij].astype(np.int64)
                res_b -= np.int64(ks_b[i, j, aij])
    return _wrap32(res_a), _wrap32(res_b)


def bootstrap_woks(a, b, mu, bk, params: TfheParams):
    """tfhe_bootstrap_woKS (ref lwe-bootstrapping-functions.cu:129-155).

    a: [n] int32, b: int32 scalar, bk: [n, kpl, k+1, N] int32.
    Returns extracted (a_ext[k*N], b_ext).
    """
    N, k = params.N, params.k
    Nx2 = 2 * N
    barb = int(mod_switch_from_torus32(np.int32(b), Nx2))
    bara = mod_switch_from_torus32(np.asarray(a, np.int32), Nx2)
    testvect = np.full(N, np.int32(mu), np.int32)
    if barb != 0:
        testvect = mul_by_xai(Nx2 - barb, testvect)
    acc = np.zeros((k + 1, N), np.int32)
    acc[k] = testvect
    acc = blind_rotate(acc, bk, bara, params)
    return sample_extract(acc, params)


def bootstrap(a, b, mu, bk, ks_a, ks_b, params: TfheParams):
    """Full gate bootstrap: blind rotate + extract + key switch
    (ref lwe-bootstrapping-functions-fft.cu:1884-1917)."""
    a_ext, b_ext = bootstrap_woks(a, b, mu, bk, params)
    return key_switch(a_ext, b_ext, ks_a, ks_b, params)
