"""The small-batch blind rotate (the serial-circuit path, and the flat
batches ``core.bootstrap.small_batch`` gives it): wrappers and plain versions.

Counterpart of ``tfhe_tpu.ops.cmux_pallas_packed.blind_rotate_fused_packed``
(K5). The wrappers keep the JAX kernel's interface and its packed layout, and
dispatch on the device of their tensors like ``ops.cmux``: a CPU tensor takes
the plain-torch version (``*_ref``, built from ``core.bootstrap``); a CUDA
tensor launches ``csrc/blind_rotate_small.cu`` (one thread-block cluster of
four or two CTAs per sample, ``small_cluster``) or raises. Each launch of that
kernel adds one to ``cmux.LAUNCHES["blind_rotate_fused_packed"]``, each launch
of the key-switch kernel behind it one to ``cmux.LAUNCHES["keyswitch"]``, and
its batch to the same names of ``cmux.SAMPLES`` (``cmux.count_launch``); the
host part of a wrapper on CUDA is the span ``tfhe.kernel.<wrapper>``.

| wrapper                      | what it launches                            |
|------------------------------|---------------------------------------------|
| blind_rotate_fused_packed    | the blind rotate alone (bootstrap_woks)     |
| blind_rotate_packed_ks_fused | the blind rotate, then the key-switch       |
|                              | kernel of cmux.cu, in one C entry point     |
|                              | (bootstrap)                                 |
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import ntt
from ..params import TfheParams
from ..core import bootstrap as bs
from ..utils.profiling import span
from ._build import check, library
from .cmux import (_acc_rows, _check_batch, _check_params, _check_tks, _expect, _kernel_tables,
                   _on_cuda, _stream, count_launch, keyswitch_plan, keyswitch_ref)

LANE = 128
N_MAX = 1024    # the kernel's rows, and two steps' key rows, have to fit in shared memory


@functools.lru_cache(maxsize=None)
def samples_in_flight(N: int, cluster: int, device_index: int) -> int:
    """How many samples the card works on at once with `cluster` CTAs per
    sample (``cudaOccupancyMaxActiveClusters``); a larger batch runs in waves."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().tfhe_blind_rotate_small_in_flight(N, cluster, ctypes.byref(out)))
    return out.value


def small_cluster(B: int, N: int, device: torch.device) -> int:
    """CTAs per sample for a batch of B. A cluster of 4 (one polynomial of one
    prime each, key rows staged in shared memory, one CTA an SM) is the
    fastest per sample and serves the batches the card takes in one wave of
    such clusters (30 samples on an H100 at N = 1024); a cluster of 2 (one
    prime each, two CTAs an SM, 132 samples at once) every larger batch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return 4 if B <= samples_in_flight(N, 4, index) else 2


def _check_bk_ntt(bk: torch.Tensor, bksh: torch.Tensor, n: int, params: TfheParams) -> None:
    shape = (n, len(ntt.PRIMES), params.kpl, params.k + 1, params.N)
    for t, name in ((bk, "bk_ntt"), (bksh, "bk_ntt_shoup")):
        _expect(t, torch.uint32, shape, name)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_n(params: TfheParams) -> None:
    if params.N > N_MAX:
        raise ValueError(f"the small-batch blind rotate takes N <= {N_MAX}")


def _check_bara(bara: torch.Tensor, B: int) -> torch.Tensor:
    """bara int32[n, B] -> the per-sample rows int32[B, n] the kernel reads."""
    _expect(bara, torch.int32, (bara.shape[0], B), "bara")
    return bara.T.contiguous()


# ------------------------------------------------------------------ K5

def blind_rotate_fused_packed_ref(acc_p: torch.Tensor, bara: torch.Tensor,
                                  bk_ntt: torch.Tensor, bk_ntt_shoup: torch.Tensor,
                                  params: TfheParams) -> torch.Tensor:
    """Plain version of blind_rotate_fused_packed: the packed layout around
    ``core.bootstrap.blind_rotate``."""
    k1, N = params.k + 1, params.N
    B = acc_p.shape[0] // k1
    acc = acc_p.reshape(k1, B, N).transpose(0, 1)
    out = bs.blind_rotate(acc, bara.T, bk_ntt, bk_ntt_shoup, params)
    return out.transpose(0, 1).reshape(acc_p.shape)


def blind_rotate_fused_packed(acc_p: torch.Tensor, bara: torch.Tensor, bk_ntt: torch.Tensor,
                              bk_ntt_shoup: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Whole blind rotate of a small batch in one launch.

    acc_p: int32[(k+1)*B, N/128, 128], polynomial c of sample s at row
    c*B + s; bara: int32[n, B] in [0, 2N); bk_ntt/bk_ntt_shoup: uint32[n, P,
    kpl, k+1, N]. Returns the accumulator in the layout of acc_p."""
    if not _on_cuda(acc_p, bara, bk_ntt, bk_ntt_shoup):
        return blind_rotate_fused_packed_ref(acc_p, bara, bk_ntt, bk_ntt_shoup, params)
    with span("tfhe.kernel.blind_rotate_fused_packed", batch=bara.shape[-1]):
        _check_params(params)
        k1, N = params.k + 1, params.N
        _check_n(params)
        if N % LANE or acc_p.shape[0] % k1:
            raise ValueError("acc_p: want int32[(k+1)*B, N/128, 128]")
        B = acc_p.shape[0] // k1
        _check_batch(B, params)
        _expect(acc_p, torch.int32, (k1 * B, N // LANE, LANE), "acc_p")
        n = bara.shape[0]
        bara_b = _check_bara(bara, B)
        _check_bk_ntt(bk_ntt, bk_ntt_shoup, n, params)
        return _launch_packed(acc_p.clone(memory_format=torch.contiguous_format), bara_b, bk_ntt,
                              bk_ntt_shoup, params)


def _launch_packed(acc: torch.Tensor, bara_b: torch.Tensor, bk_ntt: torch.Tensor,
                   bk_ntt_shoup: torch.Tensor, params: TfheParams, cluster=None) -> torch.Tensor:
    """The kernel on a checked, contiguous acc in the packed layout, in place;
    `cluster` (CTAs per sample) is small_cluster's choice unless given."""
    B, n = bara_b.shape
    cluster = cluster or small_cluster(B, params.N, acc.device)
    tab = _kernel_tables(params.N, params.halfBg, str(acc.device))
    check(library().tfhe_blind_rotate_small(
        acc.data_ptr(), bara_b.data_ptr(), bk_ntt.data_ptr(), bk_ntt_shoup.data_ptr(),
        tab.data_ptr(), B, n, params.N, params.bk_Bgbit, params.decomp_offset, cluster,
        _stream(acc)))
    count_launch("blind_rotate_fused_packed", B)
    return acc


# ------------------------------------------------------- K5 + key switch

def blind_rotate_packed_ks_fused_ref(acc_t: torch.Tensor, bara: torch.Tensor,
                                     bk_ntt: torch.Tensor, bk_ntt_shoup: torch.Tensor,
                                     tks_lane: torch.Tensor, params: TfheParams):
    """Plain version of blind_rotate_packed_ks_fused."""
    acc = bs.blind_rotate(acc_t.permute(2, 0, 1), bara.T, bk_ntt, bk_ntt_shoup, params)
    return keyswitch_ref(acc.permute(1, 2, 0), tks_lane, params)


def blind_rotate_packed_ks_fused(acc_t: torch.Tensor, bara: torch.Tensor, bk_ntt: torch.Tensor,
                                 bk_ntt_shoup: torch.Tensor, tks_lane: torch.Tensor,
                                 params: TfheParams):
    """Blind rotate of a small batch, sample extract and key switch: the
    interface of ``cmux.blind_rotate_ks_fused`` with the key in the bk_ntt
    layout. acc_t: int32[k+1, N, B]; bara: int32[n, B]; tks_lane:
    int8[t*(base-1), N, 4*C]. Returns (r int32[B, C], ext int32[2, B])."""
    if not _on_cuda(acc_t, bara, bk_ntt, bk_ntt_shoup, tks_lane):
        return blind_rotate_packed_ks_fused_ref(acc_t, bara, bk_ntt, bk_ntt_shoup, tks_lane,
                                                params)
    with span("tfhe.kernel.blind_rotate_packed_ks_fused", batch=acc_t.shape[-1]):
        _check_params(params)
        _check_n(params)
        acc = _acc_rows(acc_t, params)
        B = acc.shape[0]
        n = bara.shape[0]
        bara_b = _check_bara(bara, B)
        _check_bk_ntt(bk_ntt, bk_ntt_shoup, n, params)
        C = _check_tks(tks_lane, params)
        mma, split = keyswitch_plan(B, params.N, C)
        cluster = small_cluster(B, params.N, acc.device)
        sums = torch.zeros((B, 4 * C), dtype=torch.int32, device=acc.device)
        r = torch.empty((B, C), dtype=torch.int32, device=acc.device)
        ext = torch.empty((2, B), dtype=torch.int32, device=acc.device)
        tab = _kernel_tables(params.N, params.halfBg, str(acc.device))
        check(library().tfhe_blind_rotate_small_ks(
            acc.data_ptr(), bara_b.data_ptr(), bk_ntt.data_ptr(), bk_ntt_shoup.data_ptr(),
            tab.data_ptr(), tks_lane.data_ptr(), sums.data_ptr(), r.data_ptr(), ext.data_ptr(),
            B, n, params.N, params.bk_Bgbit, params.decomp_offset, cluster, C, params.ks_t,
            params.ks_basebit, params.ks_prec_offset, mma, split, _stream(acc)))
        count_launch("blind_rotate_fused_packed", B)
        count_launch("keyswitch", B)
        return r, ext
