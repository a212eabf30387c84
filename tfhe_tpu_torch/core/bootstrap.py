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
- paired (``bootstrap_paired``: a gate that sums two bootstraps before one
  key switch, ``gates.MUX`` and ``gates.prefix_combine``): on the fused
  route the key-switch kernels sum the pairs themselves, a batch above
  ``batch_cap`` in chunks of whole pairs; elsewhere
  ``bootstrap_pairs_split`` sums the extracted samples before
  ``key_switch``. ``PAIR_KS`` counts the calls by route;
- a flat batch above ``batch_cap`` is bootstrapped in equal chunks and a
  remainder, whose outputs are concatenated (``tfhe_tpu``'s
  ``_chunked_over_batch``): the samples are independent and the math exact,
  so the result is the unchunked one, byte for byte;
- the blind rotate of a flat batch goes to the kernel that is faster for its
  size (``small_batch``): the small-batch kernel of ``ops.cmux_packed`` (K5,
  a cluster of four or two CTAs per sample: every stage of a serial circuit,
  and the gate batches that leave the other kernel's last wave mostly empty)
  or the kernels of ``ops.cmux`` that hold two whole samples in a block
  (K3/K4: every batch above its gadget length's ``small_batch_max``, and
  the batches below it that fill their last wave).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..params import TfheParams
from .. import ntt
from ..config import fuseks_enabled
from ..numeric import i32, mod_switch_from_torus32
from ..ops import cmux, cmux_packed
from ..utils.profiling import counter, span, spanned
from .lwe import LweCiphertext

@dataclass(frozen=True)
class Waves:
    """How one gadget length's blind rotates cost on the card, by batch.
    Both kernels work in waves: K5 (clusters of two CTAs) holds `k5_wave`
    samples at once, a wave takes `k5_wave_ms` and a last wave of at most half
    that `k5_tail_ms`; K3/K4 hold `k3_wave` and a wave takes `k3_wave_ms`.
    K5 in clusters of four (``cmux_packed.small_cluster``: the samples the card
    holds at once that way) takes `k5_c4_ms` whatever the batch; the key
    switch and the glue kernels around a bootstrap add `stage_glue_ms`.
    Batches above `small_batch_max` take K3/K4."""
    small_batch_max: int
    k5_wave: int
    k5_wave_ms: float
    k5_tail_ms: float
    k3_wave: int
    k3_wave_ms: float
    k5_c4_ms: float
    stage_glue_ms: float


# The routing values by gadget length l, as ``cmux.CMUX_FORMS``. The sizes of
# the waves follow from the forms' occupancy, their times are measured.
WAVES = {
    # PARAMS_110, measured on an H100 (132 SMs, 700 W) by chip_smoke.py's sweep
    # of B = 1 to 4096. K5 holds 132 samples at once (two CTAs a sample, two
    # CTAs an SM) and a wave takes 3.5-3.7 ms; a last wave of at most half that
    # (one CTA an SM) 1.9-2.3 ms. K3/K4 hold 264 (two samples a block, one
    # block an SM) and a wave takes 6.1-6.2 ms: 23.3 us a sample against K5's
    # 27, but a wave twice as long. So K3/K4 win wherever their last wave is
    # full enough (B = 264: 6.15 against 7.36 ms; 528: 12.34 against 14.38;
    # 792: 18.49 against 21.47) and lose between (192: 6.16 against 5.70; 265:
    # 12.34 against 9.23; 660: 18.58 against 17.97), and from 858 on they win
    # or tie at every batch (1056: 24.73 against 28.43; 2048: 49.31 against
    # 56.30; 4096: 98.5 against 110.2). One stage of a serial circuit: K5 in
    # clusters of four (30 samples at N = 1024) takes 1.830 ms at B = 1, 1.845
    # at 30, its 500 dependent CMux steps and not its samples set the time;
    # add16 replayed, 16 stages of 2 samples, takes 30.6-31.6 ms, ~1.94 ms a
    # stage. A prefix level or a MUX sums its pairs inside the key-switch
    # kernels behind its blind rotate (``bootstrap_paired``), so it costs
    # what any stage of its batch does: it pays no key switch of its own
    # through torch._int_mm (~0.75 ms a stage), which the estimate leaves out.
    2: Waves(small_batch_max=858, k5_wave=132, k5_wave_ms=3.6, k5_tail_ms=2.1,
             k3_wave=264, k3_wave_ms=6.2, k5_c4_ms=1.84, stage_glue_ms=0.1),
    # PARAMS_128 (l = 3, n = 630, N = 1024), from a sweep of B = 1 to 4096 on
    # an H100 (700 W) (PERF.md, section 6). The waves hold as many samples as at
    # l = 2: K5 in clusters of two still fits two CTAs an SM (92 KB each), 132
    # samples, and K3/K4's form (2, 1) one block of two samples an SM, 264. A
    # K5 wave takes 6.0-6.6 ms, a last wave of at most half that 3.0-4.1; a
    # K3/K4 wave 9.8-10.1 ms; K5 in clusters of four 2.92-2.99 ms up to 30
    # samples. The measured better route at each batch of the sweep is the one
    # small_batch picks, but at 858 (K5 39.2 against K3 39.5 ms); close calls:
    # 660 (K5 30.4 against 29.7, K3 taken) and 858.
    3: Waves(small_batch_max=858, k5_wave=132, k5_wave_ms=6.3, k5_tail_ms=3.6,
             k3_wave=264, k3_wave_ms=10.0, k5_c4_ms=2.95, stage_glue_ms=0.1),
}


def waves(params: TfheParams) -> Waves:
    """The routing values of `params`' gadget length. A set the kernels do
    not take (another l: the CPU path only, where both routes are the same
    plain pieces) routes as l = 2."""
    return WAVES.get(params.bk_l, WAVES[2])


def k5_ms(B: int, params: TfheParams) -> float:
    """K5's time for a flat batch of B in clusters of two, by its waves."""
    w = waves(params)
    full, tail = divmod(B, w.k5_wave)
    return full * w.k5_wave_ms + (0.0 if tail == 0 else
                                  w.k5_tail_ms if 2 * tail <= w.k5_wave else w.k5_wave_ms)


def k3_ms(B: int, params: TfheParams) -> float:
    """K3's (and K4's) time for a flat batch of B, by its waves."""
    w = waves(params)
    return -(-B // w.k3_wave) * w.k3_wave_ms


def small_batch(B: int, params: TfheParams) -> bool:
    """True when the small-batch blind rotate (K5) is the faster one for a
    flat batch of B samples of `params`, by the measured wave times of
    ``WAVES``; the sweep in chip_smoke.py prints this choice beside the
    measured times (PERF.md, "Findings")."""
    return B <= waves(params).small_batch_max and k5_ms(B, params) <= k3_ms(B, params)


def card_index(device: torch.device) -> int:
    """The index of the card `device` names, the current card where it names none."""
    return device.index if device.index is not None else torch.cuda.current_device()


def in_flight(device: torch.device, params: TfheParams) -> int:
    """The samples the card holds at once in K5's clusters of four
    (``cmux_packed.samples_in_flight``); 0 off the card or where K5 cannot run."""
    if device.type != "cuda" or params.N > cmux_packed.N_MAX:
        return 0
    return cmux_packed.samples_in_flight(params.N, 4, card_index(device), params.bk_l)


def stage_ms(B: int, params: TfheParams, device) -> float:
    """The estimated time of one bootstrap of a flat batch of B of `params`
    on the card `device`, by the route it takes: K5 in clusters of four up to
    ``in_flight`` samples, else the blind rotate ``small_batch`` picks; then
    the key switch and glue."""
    w = waves(params)
    held = in_flight(torch.device(device), params)
    if B <= held:
        rotate = w.k5_c4_ms
    else:
        rotate = k5_ms(B, params) if held and small_batch(B, params) else k3_ms(B, params)
    return rotate + w.stage_glue_ms


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
    return params.N <= cmux_packed.N_MAX and small_batch(B, params)


def _route(B: int, params: TfheParams, fused: bool, pairs: int = 0) -> str:
    """The blind rotate a flat batch of B takes, as a bootstrap's span names
    it: K4 or K5 with the key switch in the same wrapper (``_pairs``: the key
    switch paired), K3 or K5 without."""
    if fused:
        return ("k5" if _small(B, params) else "k4") + ("_pairs" if pairs else "")
    return "k5_woks" if _small(B, params) else "k3"


def _form(route: str, B: int, params: TfheParams, device: torch.device) -> str:
    """The form of the blind rotate of `route` for a batch of B, as its
    wrapper's span names it: "S/nbuf" for K3/K4, "c4" or "c2" for K5;
    "plain" where the plain version runs (CPU tensors, or a set the kernels
    do not take)."""
    if device.type != "cuda" or params.bk_l not in cmux.CMUX_FORMS:
        return "plain"
    if route.startswith("k5"):
        return f"c{cmux_packed.small_cluster(B, params.N, device, params.bk_l)}"
    return cmux.form_name(*cmux.blind_rotate_plan(params.N, params.bk_l))


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
    return _card_cap(card_index(device), key_bytes, cloud.params.N)


def route_fingerprint(device: torch.device, cloud) -> tuple:
    """The routing values a bootstrap reads at call time (``ops.cmux``'s arms
    and forms, ``WAVES``) and, with a cloud key, the batch cap on `device`:
    part of the key of a captured circuit (``arith.circuit_key``), so that a
    graph is never replayed under another route than its capture's."""
    cap = None if cloud is None else batch_cap(torch.device(device), cloud)
    return (cmux.KS_GATHER_MAX, cmux.KS_GATHER_BLOCKS, cmux.KS_GATHER_MIN_COEFFS,
            cmux.KS_MMA_BLOCKS, tuple(cmux.CMUX_FORMS.items()), tuple(WAVES.items()), cap)


def _chunked(impl, x: LweCiphertext, mu, cloud, woks: bool = False, pairs: int = 0):
    """impl(x, mu, cloud) over equal chunks of batch_cap() samples and a
    remainder, outputs concatenated (an LweCiphertext, or a tuple of tensors).
    A per-sample mu is split with the samples. The span ``tfhe.bootstrap``
    names the route and form of the first chunk (`woks`: impl stops before
    the key switch; `pairs`: impl's key switch is paired, on a batch in one
    chunk), the gadget length, the batch and the chunks."""
    B = x.b.shape[0]
    cap = batch_cap(x.device, cloud)
    with span("tfhe.bootstrap") as sp:
        if sp:
            fused = not woks and _fused(x, cloud)
            route = _route(min(B, cap), cloud.params, fused, pairs)
            sp.set(route=route, form=_form(route, min(B, cap), cloud.params, x.device),
                   l=cloud.params.bk_l, batch=B, parts=-(-B // cap))
            if pairs:
                sp.set(pairs=pairs)
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
def finish_fused_ks(r: torch.Tensor, ext: torch.Tensor, params: TfheParams,
                    pairs: int = 0) -> LweCiphertext:
    """The sample from the fused kernel's outputs: r int32[B, C] (recombined
    key-switch sums) and ext int32[2, B] (b_ext, count of nonzero digits).
    The first `pairs` outputs sum two bootstraps: their cv is the two
    variances and the key switch's, summed as bootstrap_pairs_split does."""
    n = params.n
    if pairs:
        cv = torch.full((r.shape[0],), _bootstrap_variance(params), dtype=torch.float32,
                        device=r.device)
        cv[:pairs] *= 2
        cv = cv + ext[1].to(torch.float32) * params.ks_stdev ** 2
    else:
        cv = ext[1].to(torch.float32) * params.ks_stdev ** 2 + _bootstrap_variance(params)
    return LweCiphertext(-r[:, :n], ext[0] - r[:, n], cv)


def _bootstrap_fused_ks(x: LweCiphertext, mu, cloud, pairs: int = 0,
                        b_add: int = 0) -> LweCiphertext:
    """bootstrap() through a blind rotate, extract and key switch in one
    wrapper, the key switch paired where `pairs` > 0."""
    params: TfheParams = cloud.params
    acc, bara = _prepare_acc(x, mu, cloud)
    if _small(x.b.shape[0], params):
        r, ext = cmux_packed.blind_rotate_packed_ks_fused(
            acc.permute(1, 2, 0), bara.T, cloud.bk_ntt, cloud.bk_ntt_shoup,
            cloud.ks_table_perm, params, pairs, b_add)
    else:
        r, ext = cmux.blind_rotate_ks_fused(acc.permute(1, 2, 0), bara.T, cloud.bk_rows,
                                            cloud.bk_rows_shoup, cloud.ks_table_perm, params,
                                            pairs, b_add)
    return finish_fused_ks(r, ext, params, pairs)


# The paired bootstraps (``bootstrap_paired``) by route: "kernel", the
# key-switch kernels sum the pairs (the fused route), and "split", the sum of
# extracted samples goes through ``key_switch``. Counted where each route
# runs (a counter of ``utils.profiling``: replays carry it).
PAIR_KS = counter("pair_ks", ("kernel", "split"))


def bootstrap(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    """Full gate bootstrap (ref tfhe_bootstrap_FFT, lwe-bootstrapping-functions-fft.cu:1884).

    x: flat batch [B], split above batch_cap()."""
    return _chunked(_bootstrap_whole, x, mu, cloud)


def bootstrap_paired(x: LweCiphertext, mu, cloud, pairs: int, b_add: int) -> LweCiphertext:
    """A gate that sums two bootstraps before one key switch (``gates.MUX``,
    ``gates.prefix_combine``). x: flat batch of 2P + R samples, P = `pairs`;
    the P + R outputs are the key switch of extracted samples i and P + i
    summed with (0, `b_add`), i < P, then of samples 2P .. 2P + R - 1.

    On the fused route the key-switch kernels sum the pairs: a batch above
    batch_cap() goes in chunks of whole pairs (samples i0..i1 and
    P + i0..P + i1 together), then the R unpaired samples. Elsewhere,
    bootstrap_pairs_split."""
    P, B = pairs, x.b.shape[0]
    cmux.ks_outputs(B, P)
    if not _fused(x, cloud):
        return bootstrap_pairs_split(x, mu, cloud, P, b_add)
    PAIR_KS["kernel"] += 1
    cap = batch_cap(x.device, cloud)
    if B <= cap:
        return _paired_fused(x, mu, cloud, P, b_add)
    per_sample = isinstance(mu, torch.Tensor) and mu.dim() > 0 and mu.shape[0] == B
    step = max(1, cap // 2)
    parts = []
    for i0 in range(0, P, step):
        i1 = min(P, i0 + step)
        idx = torch.cat([torch.arange(i0, i1, device=x.device),
                         torch.arange(P + i0, P + i1, device=x.device)])
        parts.append(_paired_fused(x[idx], mu[idx] if per_sample else mu, cloud, i1 - i0,
                                   b_add))
    if B > 2 * P:
        parts.append(_chunked(_bootstrap_whole, x[2 * P:], mu[2 * P:] if per_sample else mu,
                              cloud))
    return LweCiphertext(*(torch.cat([getattr(p, f) for p in parts]) for f in ("a", "b", "cv")))


def _paired_fused(x: LweCiphertext, mu, cloud, pairs: int, b_add: int) -> LweCiphertext:
    """bootstrap_paired's fused route on at most batch_cap() samples."""
    return _chunked(functools.partial(_bootstrap_fused_ks, pairs=pairs, b_add=b_add),
                    x, mu, cloud, pairs=pairs)


def bootstrap_pairs_split(x: LweCiphertext, mu, cloud, pairs: int, b_add: int) -> LweCiphertext:
    """bootstrap_paired on the split route: bootstrap_woks, the pairs'
    extracted samples summed with (0, `b_add`), then key_switch."""
    P = pairs
    a_ext, b_ext, cv = bootstrap_woks(x, mu, cloud)
    PAIR_KS["split"] += 1
    return key_switch(torch.cat([a_ext[:P] + a_ext[P:2 * P], a_ext[2 * P:]]),
                      torch.cat([b_add + b_ext[:P] + b_ext[P:2 * P], b_ext[2 * P:]]),
                      cloud.ks_table, torch.cat([cv[:P] + cv[P:2 * P], cv[2 * P:]]),
                      cloud.params)


def _fused(x: LweCiphertext, cloud) -> bool:
    return fuseks_enabled(x.device) and cloud.params.k == 1


def _bootstrap_whole(x: LweCiphertext, mu, cloud) -> LweCiphertext:
    if _fused(x, cloud):
        return _bootstrap_fused_ks(x, mu, cloud)
    a_ext, b_ext, cv = _bootstrap_woks_whole(x, mu, cloud)
    return key_switch(a_ext, b_ext, cloud.ks_table, cv, cloud.params)
