"""CMux kernels of the blind rotate: wrappers, plain versions and tables.

Counterpart of ``tfhe_tpu.ops.cmux_pallas``. Each wrapper keeps the JAX
kernel's array layouts at its interface, and dispatches on the device of its
tensors: a CPU tensor takes the plain-torch version (``*_ref``, built from
``core.bootstrap``'s pieces); a CUDA tensor launches the hand-written kernel
of ``csrc/cmux.cu`` or raises. Each launch adds one to ``LAUNCHES[name]`` and
its batch to ``SAMPLES[name]``; a batch beyond ``max_batch`` is refused. The
host part of a wrapper on the bootstrap's path (K3, K4 and the key switch) on
CUDA (checks, plans, the library call) is the span ``tfhe.kernel.<wrapper>``
(``utils.profiling.span``).

| wrapper                | TPU kernel it replaces                          |
|------------------------|-------------------------------------------------|
| cmux_delta             | cmux_pallas.cmux_delta (one external product)   |
| blind_rotate_step      | cmux_pallas.blind_rotate_step (one CMux step)   |
| blind_rotate_fused     | cmux_pallas.blind_rotate_fused (all n steps)    |
| blind_rotate_ks_fused  | cmux_pallas.blind_rotate_ks_fused (+ extract    |
|                        | and key switch)                                 |
| keyswitch              | the key-switch epilogue of the above, alone     |

The blind-rotate kernels (K1-K4) hold S whole samples in a block, which walk
the steps together and share each read of a key slice; ``blind_rotate_plan``
picks the form (S, key buffers in shared memory) that fits the block at this
N, and the last block of a batch that S does not divide holds fewer samples.
The key-switch kernel has two arms behind one entry point
(``keyswitch_plan``): a gather spread over the card for small batches and a
one-hot int8 product on the tensor cores for large ones.

Every entry point launches on torch's current stream and nothing on a
wrapper's path copies from the host or reads back from the card, so a CUDA
graph captures a whole circuit of them (``arith.circuit``): the first call
loads the library, raises the kernels' shared-memory limits and reads the
card's occupancy, all before the capture, and the graph replays the launches
that ``LAUNCHES`` and ``SAMPLES`` counted while it was captured.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import ntt
from ..params import TfheParams
from ..core import bootstrap as bs
from ..utils.profiling import span
from ._build import check, library

# one count per TPU kernel replaced, and one for the key-switch kernel, which
# every wrapper that launches it raises; blind_rotate_fused_packed (K5) is
# launched by the wrappers of ops/cmux_packed.py
LAUNCHES = {"cmux_delta": 0, "blind_rotate_step": 0, "blind_rotate_fused": 0,
            "blind_rotate_ks_fused": 0, "blind_rotate_fused_packed": 0, "keyswitch": 0}
# the samples those launches held: what each route of a circuit took, whose
# stages walk through every batch size (core.bootstrap.small_batch)
SAMPLES = dict.fromkeys(LAUNCHES, 0)

# Largest batch whose key switch takes the gather arm; a larger one takes the
# tensor-core arm. Measured on an H100 (700 W) at PARAMS_110 by chip_smoke.py:
# in the key-switch sweep the gather arm wins at B = 16 (0.053 against 0.063
# ms) and loses at B = 24 (0.074 against 0.070 ms); its time grows with B
# (12.6 MB of table rows per sample through L2), the tensor-core arm's hardly.
# End to end ([circuits], the arms in turns): with the tensor-core arm forced
# at every B a 16-bit add takes 33.0-33.1 ms against 32.3 ms, a division 737
# against 724 ms: the gather arm is worth 0.04-0.05 ms a stage, about 2 % of
# a serial operation (PERF.md).
KS_GATHER_MAX = 16
KS_GATHER_BLOCKS = 1024     # gather arm: blocks in flight aimed at, over all samples
KS_GATHER_MIN_COEFFS = 4    # gather arm: fewest coefficients of a sample per block
KS_MMA_BLOCKS = 256         # tensor-core arm: blocks aimed at
KS_MMA_ROWS = 128           # tensor-core arm: samples per block (csrc/cmux.cu kMmaRows)
KS_MMA_COLS = 128           # tensor-core arm: table bytes per row per block (kMmaCols)
KS_MMA_STEP = 32            # tensor-core arm: coefficients per product step

# Forms of the kernels that hold S samples in a block (csrc/extern_product.cuh):
# (S, key buffers in shared memory; 0 buffers: the product reads the key from
# L2). Measured on an H100 (700 W) at PARAMS_110 by chip_smoke.py's sweep: two
# samples with a double buffer take 6.15 ms at B = 256 and 49.2 ms at 2048; one
# sample without buffers, two blocks an SM, 7.5 and 57.3 ms (4.4 ms up to 132
# samples, which the small-batch kernel does in 1.8-3.8). Two forms went after
# that sweep: two samples without buffers (7.0 and 56.1 ms) and four samples
# with one buffer (12.4 and 50.1 ms) (PERF.md).
CMUX_FORMS = ((2, 2), (1, 0))
SMEM_MAX = 232448           # bytes of shared memory a block may use on sm_90


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = SAMPLES[name] = 0


def count_launch(name: str, B: int) -> None:
    """One launch of kernel `name` on B samples; called where a wrapper has
    launched its kernel, and nowhere else."""
    LAUNCHES[name] += 1
    SAMPLES[name] += B


# ------------------------------------------------------------------ tables

@functools.lru_cache(maxsize=None)
def _twiddle_stack(N: int, half_bg: int) -> np.ndarray:
    """uint32[P, N, 5] twiddle columns: psi_br, psi_br_shoup, ipsi_br,
    ipsi_br_shoup and NTT_p(half_bg * ones(N)), the offset-digit correction
    (digits stay in [0, Bg) inside the kernels; subtracting this fixed
    transform restores the signed decomposition exactly).

    These are the first five columns of ``cmux_pallas._twiddle_stack``; its
    further columns serve the TPU's roll-select butterflies only."""
    cols_per_prime = []
    for p in ntt.PRIMES:
        tabs = ntt.ntt_tables(N, p)
        ones_hat = ntt.ntt_forward_np(np.full(N, half_bg % p, np.uint64), N, p)
        cols_per_prime.append(np.stack(
            [tabs["psi_br"], tabs["psi_br_shoup"], tabs["ipsi_br"],
             tabs["ipsi_br_shoup"], ones_hat], axis=1))
    return np.stack(cols_per_prime)


def _kernel_constants(N: int) -> np.ndarray:
    """The 16 uint32 constants after the twiddles (csrc/ntt_passes.cuh)."""
    vals = []
    for p in ntt.PRIMES:
        t = ntt.ntt_tables(N, p)
        vals += [p, int(t["n_inv"]), int(t["n_inv_shoup"]), int(t["ipsi1_ninv"]),
                 int(t["ipsi1_ninv_shoup"])]
    vals += [ntt._INV_P1_MOD_P2, ntt._INV_P1_SHOUP, ntt._T_HALF, ntt._R1_HALF,
             ntt._M_MOD_2_32, 0]
    return np.array(vals, np.uint32)


@functools.lru_cache(maxsize=None)
def _kernel_tables(N: int, half_bg: int, device: str) -> torch.Tensor:
    """uint32[P][5][N] twiddles followed by the constants, on `device`."""
    tw = np.ascontiguousarray(_twiddle_stack(N, half_bg).transpose(0, 2, 1))
    buf = np.concatenate([tw.reshape(-1), _kernel_constants(N)])
    return torch.from_numpy(buf).to(device)


# ------------------------------------------------------------------ checks

def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, "
                     f"got {[str(t.device) for t in tensors]}")


def _expect(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}")


def _check_bk(bk: torch.Tensor, bksh: torch.Tensor, lead: tuple, params: TfheParams) -> None:
    shape = lead + (len(ntt.PRIMES), params.N, params.kpl * (params.k + 1))
    for t, name in ((bk, "bk"), (bksh, "bk_shoup")):
        _expect(t, torch.uint32, shape, name)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_tks(tks_lane: torch.Tensor, params: TfheParams) -> int:
    """Check the permuted KS limb table; returns C (columns per limb plane)."""
    TB, C4 = params.ks_t * (params.ks_base - 1), tks_lane.shape[-1]
    _expect(tks_lane, torch.int8, (TB, params.N, C4), "tks_lane")
    if C4 % 512 or C4 // 16 > 1024 or not tks_lane.is_contiguous():
        raise ValueError("tks_lane: want contiguous, 4*C with C a multiple of 128")
    return C4 // 4


def _check_params(params: TfheParams) -> None:
    if params.k != 1 or params.bk_l != 2 or not 64 <= params.N <= 2048:
        raise ValueError("the CUDA kernels take k = 1, l = 2 and 64 <= N <= 2048")


def max_batch(N: int) -> int:
    """The largest batch the kernels index. The C entry points take B and the
    accumulator's strides as int: the (k+1)*N*B words of the accumulator stay
    under 2^31 (1,048,575 samples at N = 1024); the tensor-core arm of the key
    switch puts KS_MMA_ROWS samples on each of at most 65,535 rows of its grid."""
    return min((2 ** 31 - 1) // (2 * N), 65535 * KS_MMA_ROWS)


def _check_batch(B: int, params: TfheParams) -> None:
    if not 1 <= B <= max_batch(params.N):
        raise ValueError(f"batch of {B}: the CUDA kernels take 1 to {max_batch(params.N)} "
                         f"samples at N = {params.N}; bootstrap a larger batch in parts")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _acc_rows(acc_t: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """acc_t int32[k+1, N, B] -> a fresh contiguous int32[B, k+1, N] the
    kernels update in place."""
    _expect(acc_t, torch.int32, (params.k + 1, params.N, acc_t.shape[-1]), "acc_t")
    _check_batch(acc_t.shape[-1], params)
    return acc_t.permute(2, 0, 1).clone(memory_format=torch.contiguous_format)


def _bk_ntt_view(bk_rows: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """[..., P, N, kpl*(k+1)] -> view [..., P, kpl, k+1, N] (the bk_ntt layout)."""
    return bk_rows.unflatten(-1, (params.kpl, params.k + 1)).movedim(-3, -1)


def cmux_smem_bytes(N: int, S: int, nbuf: int) -> int:
    """Shared memory of a block of the form (S, nbuf) at this N: the layout
    CmuxBlock of csrc/extern_product.cuh in bytes (key buffers with Shoup
    twins, twiddles of both primes, barriers, constants, accumulators and, a
    sample, four padded rows and one word)."""
    row = N + N // 8 + 2
    words = nbuf * 2 * 8 * N + 8 * N + 4 + 16 + S * 2 * N + S * (4 * row + 1)
    return 4 * words


def cmux_threads(N: int, S: int) -> int:
    """Threads of a block of S samples: N/2 a sample."""
    return S * N // 2


def blind_rotate_plan(N: int) -> tuple:
    """(S, nbuf): the form of blind_rotate_kernel and cmux_delta_kernel at
    this N, the first of CMUX_FORMS that fits a block's shared memory. Block b
    holds samples b*S .. b*S + S-1; the last block of a batch that S does not
    divide holds fewer."""
    for S, nbuf in CMUX_FORMS:
        if cmux_smem_bytes(N, S, nbuf) <= SMEM_MAX and cmux_threads(N, S) <= 1024:
            return S, nbuf
    raise ValueError(f"no form of the blind-rotate kernel fits N = {N}")


def _launch_rotate(acc: torch.Tensor, bara: torch.Tensor, bk: torch.Tensor,
                   bksh: torch.Tensor, params: TfheParams, form=None) -> None:
    """The blind-rotate kernel on a checked, contiguous acc int32[B, k+1, N],
    in place; `form` (S, nbuf) is blind_rotate_plan's choice unless given."""
    B, n = bara.shape
    S, nbuf = form or blind_rotate_plan(params.N)
    tab = _kernel_tables(params.N, params.halfBg, str(acc.device))
    check(library().tfhe_blind_rotate(
        acc.data_ptr(), bara.data_ptr(), bk.data_ptr(), bksh.data_ptr(), tab.data_ptr(),
        B, n, params.N, params.bk_Bgbit, params.decomp_offset, S, nbuf, _stream(acc)))


# ------------------------------------------------------------------ K1

def cmux_delta_ref(dec_t: torch.Tensor, bk_j: torch.Tensor, bksh_j: torch.Tensor,
                   params: TfheParams) -> torch.Tensor:
    """Plain version of cmux_delta."""
    out = bs.extern_product_ntt(dec_t.permute(2, 0, 1), _bk_ntt_view(bk_j, params),
                                _bk_ntt_view(bksh_j, params), params)
    return out.permute(1, 2, 0)


def cmux_delta(dec_t: torch.Tensor, bk_j: torch.Tensor, bksh_j: torch.Tensor,
               params: TfheParams, form=None) -> torch.Tensor:
    """One external product. dec_t: int32[kpl, N, B] signed digits in
    [-Bg/2, Bg/2); bk_j/bksh_j: uint32[P, N, kpl*(k+1)] (one step of bk_rows).
    Returns delta int32[k+1, N, B]. `form`: as _launch_rotate."""
    if not _on_cuda(dec_t, bk_j, bksh_j):
        return cmux_delta_ref(dec_t, bk_j, bksh_j, params)
    _check_params(params)
    B = dec_t.shape[-1]
    _check_batch(B, params)
    _expect(dec_t, torch.int32, (params.kpl, params.N, B), "dec_t")
    _check_bk(bk_j, bksh_j, (), params)
    dec = dec_t.permute(2, 0, 1).contiguous()
    out = torch.empty((B, params.k + 1, params.N), dtype=torch.int32, device=dec.device)
    tab = _kernel_tables(params.N, params.halfBg, str(dec.device))
    S, nbuf = form or blind_rotate_plan(params.N)
    check(library().tfhe_cmux_delta(
        dec.data_ptr(), bk_j.data_ptr(), bksh_j.data_ptr(), tab.data_ptr(), out.data_ptr(),
        B, params.N, S, nbuf, _stream(dec)))
    count_launch("cmux_delta", B)
    return out.permute(1, 2, 0)


# ------------------------------------------------------------------ K2

def blind_rotate_step_ref(acc_t: torch.Tensor, bara_j: torch.Tensor, bk_j: torch.Tensor,
                          bksh_j: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Plain version of blind_rotate_step."""
    out = bs.blind_rotate(acc_t.permute(2, 0, 1), bara_j.T, _bk_ntt_view(bk_j, params)[None],
                          _bk_ntt_view(bksh_j, params)[None], params)
    return out.permute(1, 2, 0)


def blind_rotate_step(acc_t: torch.Tensor, bara_j: torch.Tensor, bk_j: torch.Tensor,
                      bksh_j: torch.Tensor, params: TfheParams, form=None) -> torch.Tensor:
    """One CMux step. acc_t: int32[k+1, N, B]; bara_j: int32[1, B] in [0, 2N);
    bk_j/bksh_j: uint32[P, N, kpl*(k+1)]. Returns the new accumulator. On CUDA
    it is the blind-rotate kernel with n = 1."""
    if not _on_cuda(acc_t, bara_j, bk_j, bksh_j):
        return blind_rotate_step_ref(acc_t, bara_j, bk_j, bksh_j, params)
    _check_params(params)
    acc = _acc_rows(acc_t, params)
    _expect(bara_j, torch.int32, (1, acc.shape[0]), "bara_j")
    _check_bk(bk_j, bksh_j, (), params)
    _launch_rotate(acc, bara_j.T.contiguous(), bk_j, bksh_j, params, form)
    count_launch("blind_rotate_step", acc.shape[0])
    return acc.permute(1, 2, 0)


# ------------------------------------------------------------------ K3

def blind_rotate_fused_ref(acc_t: torch.Tensor, bara: torch.Tensor, bk_rows: torch.Tensor,
                           bksh_rows: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Plain version of blind_rotate_fused."""
    out = bs.blind_rotate(acc_t.permute(2, 0, 1), bara.T, _bk_ntt_view(bk_rows, params),
                          _bk_ntt_view(bksh_rows, params), params)
    return out.permute(1, 2, 0)


def blind_rotate_fused(acc_t: torch.Tensor, bara: torch.Tensor, bk_rows: torch.Tensor,
                       bksh_rows: torch.Tensor, params: TfheParams, form=None) -> torch.Tensor:
    """The whole blind rotate (all n CMux steps) in one launch.

    acc_t: int32[k+1, N, B]; bara: int32[n, B]; bk_rows/bksh_rows:
    uint32[n, P, N, kpl*(k+1)]. Returns the accumulator int32[k+1, N, B].
    `form`: as _launch_rotate."""
    if not _on_cuda(acc_t, bara, bk_rows, bksh_rows):
        return blind_rotate_fused_ref(acc_t, bara, bk_rows, bksh_rows, params)
    with span("tfhe.kernel.blind_rotate_fused", batch=acc_t.shape[-1]):
        _check_params(params)
        acc = _acc_rows(acc_t, params)
        n = bara.shape[0]
        _expect(bara, torch.int32, (n, acc.shape[0]), "bara")
        _check_bk(bk_rows, bksh_rows, (n,), params)
        _launch_rotate(acc, bara.T.contiguous(), bk_rows, bksh_rows, params, form)
        count_launch("blind_rotate_fused", acc.shape[0])
        return acc.permute(1, 2, 0)


# ------------------------------------------------------------------ key switch

def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def gather_split(B: int, N: int) -> int:
    """Gather arm: blocks per sample, each with N/split coefficients."""
    return min(_pow2_floor(KS_GATHER_BLOCKS // B), max(1, N // KS_GATHER_MIN_COEFFS))


def mma_split(B: int, N: int, C: int) -> int:
    """Tensor-core arm: ranges of N, each a block per tile of samples and columns."""
    tiles = (4 * C // KS_MMA_COLS) * -(-B // KS_MMA_ROWS)
    return min(_pow2_floor(KS_MMA_BLOCKS // tiles), N // KS_MMA_STEP)


def keyswitch_plan(B: int, N: int, C: int) -> tuple:
    """(mma, split) for a key switch of B samples: which arm of the kernel
    runs, and into how many equal coefficient ranges [i*N/split, (i+1)*N/split)
    the N coefficients of a sample are cut, one block (gather arm) or one
    block per tile of samples and columns (tensor-core arm) each."""
    if B <= KS_GATHER_MAX:
        return 0, gather_split(B, N)
    return 1, mma_split(B, N, C)


def _launch_keyswitch(acc: torch.Tensor, tks_lane: torch.Tensor, params: TfheParams, plan=None):
    """The key-switch kernel on acc int32[B, k+1, N] (contiguous, on the card)."""
    B = acc.shape[0]
    C = _check_tks(tks_lane, params)
    mma, split = plan or keyswitch_plan(B, params.N, C)
    sums = torch.zeros((B, 4 * C), dtype=torch.int32, device=acc.device)
    r = torch.empty((B, C), dtype=torch.int32, device=acc.device)
    ext = torch.empty((2, B), dtype=torch.int32, device=acc.device)
    check(library().tfhe_keyswitch(
        acc.data_ptr(), tks_lane.data_ptr(), sums.data_ptr(), r.data_ptr(), ext.data_ptr(),
        B, params.N, C, params.ks_t, params.ks_basebit, params.ks_prec_offset, mma, split,
        _stream(acc)))
    count_launch("keyswitch", B)
    return r, ext


def keyswitch(acc_t: torch.Tensor, tks_lane: torch.Tensor, params: TfheParams):
    """Sample extract and key switch of a rotated accumulator.

    acc_t: int32[k+1, N, B]; tks_lane: int8[t*(base-1), N, 4*C]. Returns
    (r int32[B, C], ext int32[2, B]) as blind_rotate_ks_fused."""
    if not _on_cuda(acc_t, tks_lane):
        return keyswitch_ref(acc_t, tks_lane, params)
    with span("tfhe.kernel.keyswitch", batch=acc_t.shape[-1]):
        _check_params(params)
        return _launch_keyswitch(_acc_rows(acc_t, params), tks_lane, params)


def keyswitch_ref(acc: torch.Tensor, tks_lane: torch.Tensor, params: TfheParams):
    """Plain version of the key-switch kernel on a rotated accumulator
    acc int32[k+1, N, B]: native-order extract, one-hot digit matrix,
    limb-table product, recombine. Returns (r, ext) as blind_rotate_ks_fused."""
    a0 = acc[0].T                                                           # [B, N]
    x = torch.cat([a0[:, :1], -a0[:, 1:]], dim=1)
    TB, N, C4 = tks_lane.shape
    onehot, nnz = bs.ks_onehot(x, params, with_nnz=True)     # rows (m, j, h-1)
    onehot = onehot.reshape(x.shape[0], N, TB).transpose(1, 2).reshape(x.shape[0], TB * N)
    r = bs.ks_recombine(bs.int8_matmul(onehot, tks_lane.reshape(TB * N, C4)))
    return r, torch.stack([acc[1, 0, :], nnz])


# ------------------------------------------------------------------ K4

def blind_rotate_ks_fused_ref(acc_t: torch.Tensor, bara: torch.Tensor, bk_rows: torch.Tensor,
                              bksh_rows: torch.Tensor, tks_lane: torch.Tensor,
                              params: TfheParams):
    """Plain version of blind_rotate_ks_fused: blind rotate, then keyswitch_ref."""
    acc = blind_rotate_fused_ref(acc_t, bara, bk_rows, bksh_rows, params)   # [2, N, B]
    return keyswitch_ref(acc, tks_lane, params)


def blind_rotate_ks_fused(acc_t: torch.Tensor, bara: torch.Tensor, bk_rows: torch.Tensor,
                          bksh_rows: torch.Tensor, tks_lane: torch.Tensor,
                          params: TfheParams):
    """Blind rotate, sample extract and key switch.

    acc_t: int32[k+1, N, B]; bara: int32[n, B]; tks_lane: the permuted KS limb
    table int8[t*(base-1), N, 4*C] (CloudKey.ks_table_perm). Returns
    (r int32[B, C], ext int32[2, B]); the caller finishes with
    a = -r[:, :n], b = ext[0] - r[:, n], cv from ext[1] (the count of nonzero
    digits). On CUDA: the blind-rotate kernel, then the key-switch kernel."""
    if not _on_cuda(acc_t, bara, bk_rows, bksh_rows, tks_lane):
        return blind_rotate_ks_fused_ref(acc_t, bara, bk_rows, bksh_rows, tks_lane, params)
    with span("tfhe.kernel.blind_rotate_ks_fused", batch=acc_t.shape[-1]):
        _check_params(params)
        acc = _acc_rows(acc_t, params)
        B = acc.shape[0]
        n = bara.shape[0]
        _expect(bara, torch.int32, (n, B), "bara")
        _check_bk(bk_rows, bksh_rows, (n,), params)
        C = _check_tks(tks_lane, params)
        bara_b = bara.T.contiguous()
        mma, split = keyswitch_plan(B, params.N, C)
        S, nbuf = blind_rotate_plan(params.N)
        sums = torch.zeros((B, 4 * C), dtype=torch.int32, device=acc.device)
        r = torch.empty((B, C), dtype=torch.int32, device=acc.device)
        ext = torch.empty((2, B), dtype=torch.int32, device=acc.device)
        tab = _kernel_tables(params.N, params.halfBg, str(acc.device))
        check(library().tfhe_blind_rotate_ks(
            acc.data_ptr(), bara_b.data_ptr(), bk_rows.data_ptr(), bksh_rows.data_ptr(),
            tab.data_ptr(), tks_lane.data_ptr(), sums.data_ptr(), r.data_ptr(), ext.data_ptr(),
            B, n, params.N, params.bk_Bgbit, params.decomp_offset, S, nbuf, C, params.ks_t,
            params.ks_basebit, params.ks_prec_offset, mma, split, _stream(acc)))
        count_launch("blind_rotate_ks_fused", B)
        count_launch("keyswitch", B)
        return r, ext
