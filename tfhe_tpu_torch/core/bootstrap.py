"""Batched gate bootstrapping: blind rotate -> sample extract -> key switch.

Port of ``tfhe_tpu.core.bootstrap`` (the reference's
`tfhe_bootstrap_FFT`, lwe-bootstrapping-functions-fft.cu:1884, and the fused
GPU pipeline `boot-gates.cu:2120-2629`). The pieces below are plain torch
with exact integer math; they are the CPU path and the plain versions of the
kernels. The blind rotate runs through the ``ops.cmux`` and
``ops.cmux_packed`` wrappers, which launch the CUDA kernels for CUDA tensors
and take these plain pieces for CPU tensors. Every route gives the same bits:

- fused (default on CUDA): one wrapper does the blind rotate, sample extract
  and key switch;
- split (default on the CPU): a blind-rotate wrapper, then
  ``sample_extract`` and the one-hot int8 matmul ``key_switch``;
- a flat batch above ``batch_cap`` is bootstrapped in equal chunks and a
  remainder, whose outputs are concatenated (``tfhe_tpu``'s
  ``_chunked_over_batch``): the samples are independent and the math exact,
  so the result is the unchunked one, byte for byte;
- the blind rotate of a flat batch goes to the kernel that is faster for its
  size (``small_batch``): the small-batch kernel of ``ops.cmux_packed`` (K5,
  a cluster of four or two CTAs per sample: every stage of a serial circuit,
  and the gate batches that leave the other kernel's last wave mostly empty)
  or the kernels of ``ops.cmux`` that hold two whole samples in a block
  (K3/K4: every batch above ``SMALL_BATCH_MAX``, and the batches below it
  that fill their last wave).
"""
from __future__ import annotations

import functools

import torch

from ..params import TfheParams
from .. import ntt
from ..config import fuseks_enabled
from ..numeric import i32, mod_switch_from_torus32
from ..ops import cmux, cmux_packed
from ..utils.profiling import span, spanned
from .lwe import LweCiphertext

# Which blind rotate a flat batch takes. Measured on an H100 (132 SMs, 700 W)
# at PARAMS_110 by chip_smoke.py's sweep of B = 1 to 4096: both kernels work
# in waves. K5 holds K5_WAVE = 132 samples at once (two CTAs a sample, two
# CTAs an SM) and a wave takes 3.5-3.7 ms; a last wave of at most half that
# (one CTA an SM) 1.9-2.3 ms. K3/K4 hold K3_WAVE = 264 (two samples a block,
# one block an SM) and a wave takes 6.1-6.2 ms: 23.3 us a sample against
# K5's 27, but a wave twice as long. So K3/K4 win wherever their last wave
# is full enough (B = 264: 6.15 against 7.36 ms; 528: 12.34 against 14.38;
# 792: 18.49 against 21.47) and lose between (192: 6.16 against 5.70; 265:
# 12.34 against 9.23; 660: 18.58 against 17.97), and from SMALL_BATCH_MAX on
# they win or tie at every batch (1056: 24.73 against 28.43; 2048: 49.31
# against 56.30; 4096: 98.5 against 110.2). small_batch() compares the two
# sums of waves with these times; the sweep prints its choice beside the
# measured times (PERF.md, "Findings").
SMALL_BATCH_MAX = 858
K5_WAVE, K5_WAVE_MS, K5_TAIL_MS = 132, 3.6, 2.1
K3_WAVE, K3_WAVE_MS = 264, 6.2


def small_batch(B: int) -> bool:
    """True when the small-batch blind rotate (K5) is the faster one for a
    flat batch of B samples, by the measured wave times above."""
    if B > SMALL_BATCH_MAX:
        return False
    full, tail = divmod(B, K5_WAVE)
    last = 0.0 if tail == 0 else K5_TAIL_MS if 2 * tail <= K5_WAVE else K5_WAVE_MS
    return full * K5_WAVE_MS + last <= -(-B // K3_WAVE) * K3_WAVE_MS


# ------------------------------------------------------------------ pieces

def negacyclic_rotate(x: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount * x in Z[X]/(X^N+1), batched.

    x: int32[B, C, N]; amount: int[B] in [0, 2N). Matches
    torusPolynomialMulByXai (ref toruspolynomial-functions.cu:492-520)."""
    N = x.shape[-1]
    i = torch.arange(N, device=x.device)
    d = (i[None, :] - amount.to(torch.int64)[:, None]) % (2 * N)    # [B, N] in [0, 2N)
    neg = d >= N
    idx = d - N * neg.to(torch.int64)
    take = torch.gather(x, -1, idx[:, None, :].expand(x.shape))
    return torch.where(neg[:, None, :], -take, take)


def gadget_decompose(x: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Signed gadget decomposition with the offset trick.

    x: int32[B, k+1, N] -> int32[B, kpl, N], row order c*l + p
    (ref tGswTorus32PolynomialDecompH, tgsw-functions.cu:296-340)."""
    l, Bgbit = params.bk_l, params.bk_Bgbit
    u = x + i32(params.decomp_offset)                        # wraps mod 2^32
    digs = [((u >> (32 - (p + 1) * Bgbit)) & params.maskMod) - params.halfBg
            for p in range(l)]
    dec = torch.stack(digs, dim=2)                           # [B, k+1, l, N]
    return dec.reshape(x.shape[0], params.kpl, params.N)


def extern_product_ntt(dec: torch.Tensor, bk_j: torch.Tensor, bk_sh_j: torch.Tensor,
                       params: TfheParams) -> torch.Tensor:
    """Sum_row dec_row (x) bk_row -> TLWE delta, exact via the CRT NTT.

    dec: int32[B, kpl, N]; bk_j: uint32[P, kpl, k+1, N] (NTT domain).
    Returns int32[B, k+1, N] (ref tGswFFTExternMulToTLwe,
    tgsw-fft-operations.cu:124-265). The plain version reduces with ``%``,
    so the Shoup twin `bk_sh_j`, which the kernels use, is not read here."""
    N = params.N
    dec_t = dec.permute(1, 2, 0).to(torch.int64)             # [kpl, N, B]
    w_all = bk_j.view(torch.int32).to(torch.int64)           # values < p < 2^31
    residues = []
    for pi, p in enumerate(ntt.PRIMES):
        dhat = ntt.ntt_forward_rows(dec_t % p, N, p)         # [kpl, N, B]
        w = w_all[pi][..., None]                             # [kpl, k+1, N, 1]
        prod = (dhat[:, None] * w % p).sum(0) % p            # [k+1, N, B]
        residues.append(ntt.ntt_inverse_rows(prod, N, p))
    return ntt.crt_to_i32(residues[0], residues[1]).permute(2, 0, 1)


def blind_rotate(acc: torch.Tensor, bara: torch.Tensor, bk_ntt: torch.Tensor,
                 bk_shoup: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """CMux chain over the n LWE key bits (ref tfhe_blindRotate).

    acc: int32[B, k+1, N]; bara: int32[B, n]; bk_ntt: uint32[n, P, kpl, k+1, N]."""
    for j in range(bara.shape[1]):
        rot = negacyclic_rotate(acc, bara[:, j])
        dec = gadget_decompose(rot - acc, params)
        # bara == 0 is a no-op: decompose(0) == 0 exactly (offset trick)
        acc = acc + extern_product_ntt(dec, bk_ntt[j], bk_shoup[j], params)
    return acc


def sample_extract(acc: torch.Tensor, params: TfheParams):
    """Extract the constant coefficient as an LWE sample over the extracted key
    (ref tLweExtractLweSampleIndex, lwe.cu:40-56, index=0).

    acc: int32[B, k+1, N] -> (a_ext int32[B, k*N], b_ext int32[B])."""
    k, N = params.k, params.N
    B = acc.shape[0]
    head = acc[:, :k, :1]
    tail = -torch.flip(acc[:, :k, 1:], dims=(-1,))
    a_ext = torch.cat([head, tail], dim=-1).reshape(B, k * N)
    return a_ext, acc[:, k, 0]


def ks_onehot(a_ext: torch.Tensor, params: TfheParams, with_nnz: bool = False):
    """Digit-decompose a_ext columns into the one-hot KS matmul operand.

    a_ext: int32[B, C] -> int8[B, C * t * (base-1)], row order (i, j, h-1)
    matching ks_to_limb_table (ref lwe-keyswitch-functions.cu:106-118).
    with_nnz=True also returns the per-sample count of nonzero digits
    (int32[B]), for the reference's per-digit cv (:119-125)."""
    t, basebit, base = params.ks_t, params.ks_basebit, params.ks_base
    B = a_ext.shape[0]
    aibar = a_ext + i32(params.ks_prec_offset)
    digs = torch.stack([(aibar >> (32 - (j + 1) * basebit)) & (base - 1)
                        for j in range(t)], dim=-1)                       # [B, C, t]
    hvals = torch.arange(1, base, dtype=digs.dtype, device=digs.device)
    onehot = (digs[..., None] == hvals).to(torch.int8).reshape(B, -1)
    if with_nnz:
        return onehot, (digs != 0).sum(dim=(1, 2), dtype=torch.int32)
    return onehot


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8[M, K] x int8[K, N] -> int32[M, N] (torch._int_mm).

    M is zero-padded to a multiple of 8 that is at least 32, which the CUDA
    product requires (M > 16); K and N are multiples of 8 in every table."""
    M = a.shape[0]
    Mp = max(32, -(-M // 8) * 8)
    if Mp != M:
        a = torch.cat([a, a.new_zeros((Mp - M, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b.contiguous())[:M]


def ks_recombine(sums: torch.Tensor) -> torch.Tensor:
    """int32[B, 4*C] limb-plane sums -> int32[B, C], l0 + l1<<8 + l2<<16 + l3<<24
    with int32 wrap."""
    s = sums.reshape(sums.shape[0], 4, sums.shape[1] // 4)
    return s[:, 0] + (s[:, 1] << 8) + (s[:, 2] << 16) + (s[:, 3] << 24)


def ks_finalize(sums: torch.Tensor, b_ext: torch.Tensor, cv: torch.Tensor,
                params: TfheParams, nnz: torch.Tensor | None = None) -> LweCiphertext:
    """Recombine int8 limb-plane partial sums (possibly all-reduced over the
    ranks of a sharded key switch) into the key-switched sample.

    nnz: int32[B] count of nonzero digits; the reference adds one ks-sample
    variance per nonzero digit (lwe-keyswitch-functions.cu:119-125). Without
    it the worst case, n_extract * t digits, is assumed."""
    n = params.n
    r = ks_recombine(sums)
    if nnz is None:
        cv_out = cv + float(params.n_extract * params.ks_t) * params.ks_stdev ** 2
    else:
        cv_out = cv + nnz.to(torch.float32) * params.ks_stdev ** 2
    return LweCiphertext(-r[:, :n], b_ext - r[:, n], cv_out.expand(b_ext.shape))


@spanned("tfhe.bootstrap.finish")
def key_switch(a_ext: torch.Tensor, b_ext: torch.Tensor, ks_table: torch.Tensor,
               cv: torch.Tensor, params: TfheParams) -> LweCiphertext:
    """Key switch as one one-hot int8 matmul against the limb table:
    result = (0, b_ext) - sum_{i,j} ks[i][j][digit_ij]
    (ref lweKeySwitchTranslate_fromArray, lwe-keyswitch-functions.cu:101-127)."""
    onehot, nnz = ks_onehot(a_ext, params, with_nnz=True)
    return ks_finalize(int8_matmul(onehot, ks_table), b_ext, cv, params, nnz=nnz)


# ------------------------------------------------------------------ pipeline

@spanned("tfhe.bootstrap.prepare_acc")
def _prepare_acc(x: LweCiphertext, mu, cloud):
    """Mod switch and the rotated test-vector accumulator (shared by both routes).

    Returns acc int32[B, k+1, N] and bara int32[B, n] in [0, 2N)."""
    params: TfheParams = cloud.params
    N, k = params.N, params.k
    B = x.b.shape[0]
    Nx2 = 2 * N
    barb = mod_switch_from_torus32(x.b, Nx2)                 # [B]
    bara = mod_switch_from_torus32(x.a, Nx2)                 # [B, n]
    # testvector = X^{2N-barb} * [mu, mu, ..., mu]
    # a Python mu is filled on the device: no host-to-device copy, which
    # would make the host wait for the work queued before it
    if isinstance(mu, torch.Tensor):
        mu_arr = mu.to(device=x.device, dtype=torch.int32).expand(B)
    else:
        mu_arr = torch.full((B,), int(mu), dtype=torch.int32, device=x.device)
    tv = mu_arr[:, None, None].expand(B, 1, N)
    amt = torch.where(barb == 0, torch.zeros_like(barb), Nx2 - barb)
    tvb = negacyclic_rotate(tv, amt)[:, 0]
    acc = torch.cat([torch.zeros((B, k, N), dtype=torch.int32, device=x.device),
                     tvb[:, None, :]], dim=1)
    return acc, bara


def _bootstrap_variance(params: TfheParams) -> float:
    """Post-blind-rotate variance estimate (standard TFHE noise formula)."""
    l, Bg, N, k, n = params.bk_l, params.Bg, params.N, params.k, params.n
    eps2 = (2.0 ** (-2 * l * params.bk_Bgbit)) / 4.0
    var_bk = params.bk_stdev ** 2
    return float(n * ((k + 1) * l * N * (Bg / 2.0) ** 2 * var_bk + (1 + k * N) * eps2))


def _small(B: int, params: TfheParams) -> bool:
    return params.N <= cmux_packed.N_MAX and small_batch(B)


def _route(B: int, params: TfheParams, fused: bool) -> str:
    """The blind rotate a flat batch of B takes, as a bootstrap's span names
    it: K4 or K5 with the key switch in the same wrapper, K3 or K5 without."""
    if fused:
        return "k5" if _small(B, params) else "k4"
    return "k5_woks" if _small(B, params) else "k3"


# ------------------------------------------------------------------ chunks

# Device memory a sample of a bootstrap holds at the peak, beyond the keys:
# 36.9 KiB measured on an H100 (700 W) at PARAMS_110 by chip_smoke.py's
# numerical regression (the AND batches of 272,000 samples; PERF.md), rounded up.
PEAK_BYTES_PER_SAMPLE = 37 * 1024
# The largest flat batch one call bootstraps on the CPU (the host's memory is
# not the card's; tests set a small value to split small batches).
CPU_MAX_BATCH = 1 << 16


def memory_cap(total_bytes: int, key_bytes: int, N: int) -> int:
    """The largest flat batch a card of `total_bytes` takes in one call with
    `key_bytes` of keys on it: the smaller of the batch the kernels index
    (``cmux.max_batch``) and the samples whose peak memory fits beside the keys."""
    return max(1, min(cmux.max_batch(N), (total_bytes - key_bytes) // PEAK_BYTES_PER_SAMPLE))


@functools.lru_cache(maxsize=None)
def _card_cap(index: int, key_bytes: int, N: int) -> int:
    # read once per card: the caching allocator makes free memory wander, and
    # a query at call time must never wait on the gate path's queued work
    return memory_cap(torch.cuda.get_device_properties(index).total_memory, key_bytes, N)


def batch_cap(device: torch.device, cloud) -> int:
    """The largest flat batch one bootstrap call takes on `device`; a larger
    one is split (``_chunked``)."""
    if device.type != "cuda":
        return CPU_MAX_BATCH
    keys = (cloud.bk_ntt, cloud.bk_ntt_shoup, cloud.bk_rows, cloud.bk_rows_shoup,
            cloud.ks_table, cloud.ks_table_perm)
    key_bytes = sum(t.numel() * t.element_size() for t in keys)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _card_cap(index, key_bytes, cloud.params.N)


def _chunked(impl, x: LweCiphertext, mu, cloud, woks: bool = False):
    """impl(x, mu, cloud) over equal chunks of batch_cap() samples and a
    remainder, outputs concatenated (an LweCiphertext, or a tuple of tensors).
    A per-sample mu is split with the samples. The span ``tfhe.bootstrap``
    names the route of the first chunk (`woks`: impl stops before the key
    switch), the batch and the chunks."""
    B = x.b.shape[0]
    cap = batch_cap(x.device, cloud)
    with span("tfhe.bootstrap") as sp:
        if sp:
            fused = not woks and _fused(x, cloud)
            sp.set(route=_route(min(B, cap), cloud.params, fused), batch=B, parts=-(-B // cap))
        if B <= cap:
            return impl(x, mu, cloud)
        per_sample = isinstance(mu, torch.Tensor) and mu.dim() > 0 and mu.shape[0] == B
        parts = [impl(x[s:s + cap], mu[s:s + cap] if per_sample else mu, cloud)
                 for s in range(0, B, cap)]
        if isinstance(parts[0], LweCiphertext):
            return LweCiphertext(*(torch.cat([getattr(p, f) for p in parts])
                                   for f in ("a", "b", "cv")))
        return tuple(torch.cat(vs) for vs in zip(*parts))


# ------------------------------------------------------------------ routes

def bootstrap_woks(x: LweCiphertext, mu, cloud):
    """Bootstrap without key switch: returns the extracted (a_ext, b_ext, cv)
    (ref tfhe_bootstrap_woKS_FFT, lwe-bootstrapping-functions-fft.cu:1834-1880).

    x: flat batch [B], split above batch_cap(). mu: int32 scalar or [B], the
    output message amplitude."""
    return _chunked(_bootstrap_woks_whole, x, mu, cloud, woks=True)


def _bootstrap_woks_whole(x: LweCiphertext, mu, cloud):
    params: TfheParams = cloud.params
    acc, bara = _prepare_acc(x, mu, cloud)
    k1, B, N = params.k + 1, x.b.shape[0], params.N
    if _small(B, params):
        acc_p = acc.transpose(0, 1).reshape(k1 * B, N // cmux_packed.LANE, cmux_packed.LANE)
        out_p = cmux_packed.blind_rotate_fused_packed(acc_p, bara.T, cloud.bk_ntt,
                                                      cloud.bk_ntt_shoup, params)
        acc = out_p.reshape(k1, B, N).transpose(0, 1)
    else:
        acc = cmux.blind_rotate_fused(acc.permute(1, 2, 0), bara.T, cloud.bk_rows,
                                      cloud.bk_rows_shoup, params).permute(2, 0, 1)
    a_ext, b_ext = sample_extract(acc, params)
    cv = torch.full((x.b.shape[0],), _bootstrap_variance(params), dtype=torch.float32,
                    device=x.device)
    return a_ext, b_ext, cv


@spanned("tfhe.bootstrap.finish")
def finish_fused_ks(r: torch.Tensor, ext: torch.Tensor, params: TfheParams) -> LweCiphertext:
    """The sample from the fused kernel's outputs: r int32[B, C] (recombined
    key-switch sums) and ext int32[2, B] (b_ext, count of nonzero digits)."""
    n = params.n
    cv = ext[1].to(torch.float32) * params.ks_stdev ** 2 + _bootstrap_variance(params)
    return LweCiphertext(-r[:, :n], ext[0] - r[:, n], cv)


def _bootstrap_fused_ks(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    """bootstrap() through a blind rotate, extract and key switch in one wrapper."""
    params: TfheParams = cloud.params
    acc, bara = _prepare_acc(x, mu, cloud)
    if _small(x.b.shape[0], params):
        r, ext = cmux_packed.blind_rotate_packed_ks_fused(
            acc.permute(1, 2, 0), bara.T, cloud.bk_ntt, cloud.bk_ntt_shoup,
            cloud.ks_table_perm, params)
    else:
        r, ext = cmux.blind_rotate_ks_fused(acc.permute(1, 2, 0), bara.T, cloud.bk_rows,
                                            cloud.bk_rows_shoup, cloud.ks_table_perm, params)
    return finish_fused_ks(r, ext, params)


def bootstrap(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    """Full gate bootstrap (ref tfhe_bootstrap_FFT, lwe-bootstrapping-functions-fft.cu:1884).

    x: flat batch [B], split above batch_cap()."""
    return _chunked(_bootstrap_whole, x, mu, cloud)


def _fused(x: LweCiphertext, cloud) -> bool:
    return fuseks_enabled(x.device) and cloud.params.k == 1


def _bootstrap_whole(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    if _fused(x, cloud):
        return _bootstrap_fused_ks(x, mu, cloud)
    a_ext, b_ext, cv = _bootstrap_woks_whole(x, mu, cloud)
    return key_switch(a_ext, b_ext, cloud.ks_table, cv, cloud.params)
