#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits nonzero):
  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    nvcc builds csrc/*.cu into build/tfhe_tpu_torch/, one process
              per source, all at once (seconds);
  3. kernels  every kernel against its plain-torch version on the card,
              byte-equal (tolerance: exact), and the time of each at the
              PARAMS_110 shapes of its path (K1-K4 and the key switch: batch
              256; K5, the small-batch blind rotate, and the key switch:
              batch 1) beside its plain version's, its bound (the least time
              the card could take) and, for the key switch, the one PyTorch
              call that computes the same (torch._int_mm on the one-hot
              matrix); K1 and K2 also without their wrappers' copies, at batch
              256 and 1 (what a launch and its set-up cost); K3 and K4 again at
              the first batch from which the bootstrap gives them every batch
              (SMALL_BATCH_MAX + 1),
              every form of K1-K3 at ragged batches (1, S - 1, S + 1 for S
              samples a block) and K5 at the batch of the gate path (256),
              byte-equal; the key-switch kernel alone at both arms over a
              list of batches, with all-zero and all-nonzero digits; then the
              key switch, and K5 beside every form of K3, over sweeps of the
              batch;
  4. main     the reference's keys at PARAMS_110, made on the card; a batch
              of 256 encrypted AND gates through the fused route must decrypt
              to a & b, through the kernels bootstrap.small_batch() picks for
              it (launch counters: K4, and K3 on the split route), equal the
              split route, and match the golden SHA-256 that tfhe_tpu
              computed on the CPU for 8 reference-encrypted inputs (through
              K5); then a batch beyond SMALL_BATCH_MAX the same way (K4, K3);
  5. timing   AND chained 5 times on the batch of 256, kernel route and plain
              route, in ms per batch and bootstraps/s;
  6. circuits the serial-circuit path: 16-bit CipherInt operands at one
              number per batch with the reference's keys at PARAMS_110; +, -,
              *, >, eq, abs, minimum and / must decrypt to the plaintext
              answer through K5 (launch counters), add16 must match the golden
              SHA-256 tfhe_tpu computed on the CPU, and each op's wall time
              is printed; add16 and div16 again with the key switch's
              tensor-core arm forced at every batch, in turns with the planned
              arms; then the same ops at PARAMS_SMALL on 8-bit operands
              of batch 3 must equal, byte for byte, the plain route (the same
              circuits on CPU tensors, where every wrapper takes its plain
              version);
  7. profile  one 16-bit add under torch.profiler: device time by kernel and
              the device's idle share.

The line before the last is a JSON object with the path's kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA card the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_and_golden.json")
GOLDEN_ADD16 = os.path.join(ROOT, "tests", "fixtures", "torch_port_add16_golden.json")
BATCH = 256
CHAIN = 5
SOURCE = "tfhe_tpu_torch/csrc/cmux.cu"
SOURCE_SMALL = "tfhe_tpu_torch/csrc/blind_rotate_small.cu"
# K5 beside K3: the waves of each (30 and 132 samples for K5's two forms, 264
# for K3 with two samples a block) and the batches between
SWEEP = (1, 2, 8, 30, 31, 64, 132, 133, 192, 264, 265, 396, 528, 660, 792, 1056, 1188, 1320,
         2048, 4096)
LARGE_BATCH = 2049     # K3 and K4 against plain at a batch of several waves
ROUTE_SLACK = 1.08     # the kernel small_batch() picks may be this much slower than the other
KS_CHECK = (1, 2, 3, 33, 64, 256)           # key switch against keyswitch_ref, both arms
KS_SWEEP = (1, 2, 8, 16, 24, 32, 64, 128, 256)   # key switch beside torch._int_mm
# Peak rates the bounds are taken against (NVIDIA's H100 SXM data sheet): device
# memory 3.35 TB/s, int8 tensor cores 1,979 TOP/s dense; int32 outside the
# tensor cores: 64 lanes per SM at the card's maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT32_LANES_PER_SM = 64
# int32 operations of the leanest known form of the CMux arithmetic: a lazy
# Harvey butterfly (fold 2, Shoup product 3, add, subtract) and a Shoup
# multiply-accumulate (product 3, add, fold)
OPS_PER_BUTTERFLY = 7
OPS_PER_MAC = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` runs after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, needle: str, reps: int = 10):
    """Mean device time in ms of the kernels whose name contains `needle`,
    over `reps` calls of fn() under torch.profiler: what the kernel takes when
    the CUDA events around its wrapper mostly time the host. None (not
    measured) where the profiler does not record one device event a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA and needle in ev.name]
    return sum(spans) / reps / 1e3 if len(spans) == reps else None


def max_abs_err(got, want) -> int:
    """Largest |got - want| over a tensor or a tuple of int tensors."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.dtype}{list(g.shape)} "
                                 f"vs {w.dtype}{list(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


def expect_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version, max |err| {err}")
    return err


@functools.lru_cache(maxsize=1)
def int32_ops_per_s() -> float:
    """SMs x 64 int32 lanes x the maximum SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cmux_ops(params, B: int, steps: int) -> float:
    """int32 operations of `steps` CMux steps on B samples: per prime kpl
    forward and k+1 inverse transforms of N/2 * log2(N) butterflies, and
    N * kpl * (k+1) multiply-accumulates."""
    N, primes = params.N, 2
    logn = N.bit_length() - 1
    bfly = primes * (params.kpl + params.k + 1) * (N // 2) * logn
    mac = primes * N * params.kpl * (params.k + 1)
    return float(B) * steps * (bfly * OPS_PER_BUTTERFLY + mac * OPS_PER_MAC)


def cmux_seconds(params, B: int, steps: int) -> float:
    return cmux_ops(params, B, steps) / int32_ops_per_s()


def bound(moved_bytes: float, ops_seconds: float) -> dict:
    """bound_ms: the larger of bytes over the memory rate and operations over
    their peak rates; bound_by says which."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S * 1e3, ops_seconds * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def keyswitch_work(acc_t, tks, params, outputs) -> tuple:
    """(bytes, seconds of operations) a key switch of this accumulator needs:
    the table rows its nonzero digits select, each distinct row read once
    (what this run's data needs), acc[0] read and (r, ext) written once; as
    operations the cheaper of one int32 add per selected byte and the one-hot
    int8 product."""
    from tfhe_tpu_torch.core import bootstrap as bs
    a0 = acc_t[0].T
    onehot = bs.ks_onehot(torch.cat([a0[:, :1], -a0[:, 1:]], dim=1), params)
    row_bytes = tks.shape[-1]
    rows_read = int(onehot.any(dim=0).sum().item())
    selected = int(onehot.sum(dtype=torch.int64).item())
    moved = rows_read * row_bytes + nbytes(acc_t[0], *outputs)
    adds = selected * row_bytes / int32_ops_per_s()
    product = 2.0 * onehot.shape[0] * onehot.shape[1] * row_bytes / INT8_OPS_PER_S
    return moved, min(adds, product)


def random_bk(params, n: int, rng: np.random.RandomState, device, layout: str = "rows"):
    """Random NTT-domain key slices with Shoup twins, in the bk_rows layout
    (K1-K4) or the bk_ntt layout (K5)."""
    from tfhe_tpu_torch import ntt
    from tfhe_tpu_torch.core.keys import bk_rows_layout
    bk = np.stack([rng.randint(0, p, size=(n, params.kpl, params.k + 1, params.N))
                   .astype(np.uint32) for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    if layout == "rows":
        bk, sh = bk_rows_layout(bk), bk_rows_layout(sh)
    return torch.from_numpy(bk).to(device), torch.from_numpy(sh).to(device)


def packed(acc: torch.Tensor) -> torch.Tensor:
    """acc int32[B, k+1, N] -> K5's packed layout int32[(k+1)*B, N/128, 128]."""
    B, k1, N = acc.shape
    return acc.transpose(0, 1).reshape(k1 * B, N // 128, 128)


def check_k5(params, acc, bara_t, bk, sh, tks, label: str) -> int:
    """Both K5 wrappers (the rotate alone, and rotate + key switch) against
    their plain versions on the card; returns the max |err| (0)."""
    from tfhe_tpu_torch.ops import cmux_packed as cp
    acc_p, acc_t = packed(acc), acc.permute(1, 2, 0)
    B = acc.shape[0]
    err = expect_equal(f"blind_rotate_fused_packed {label} B={B}",
                       cp.blind_rotate_fused_packed(acc_p, bara_t, bk, sh, params),
                       cp.blind_rotate_fused_packed_ref(acc_p, bara_t, bk, sh, params))
    err = max(err, expect_equal(
        f"blind_rotate_packed_ks_fused {label} B={B}",
        cp.blind_rotate_packed_ks_fused(acc_t, bara_t, bk, sh, tks, params),
        cp.blind_rotate_packed_ks_fused_ref(acc_t, bara_t, bk, sh, tks, params)))
    log(f"[kernels] K5 (blind_rotate_fused_packed, alone and with the key switch) {label} "
        f"B={B}: byte-equal to plain (max |err| {err})")
    return err


# ----------------------------------------------------------------- phases

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch.cuda: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from tfhe_tpu_torch.ops import _build
    t0 = time.time()
    path = _build.build()
    _build.library()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.time() - t0:.3f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")


def check_small_kernels() -> list:
    """K1 at PARAMS_TOY and PARAMS_110 (B = 8), K2 and K3 at PARAMS_SMALL
    (B = 3, 96): each kernel byte-equal to its plain version on the card."""
    from tfhe_tpu_torch.ops import cmux
    from tfhe_tpu_torch.params import PARAMS_TOY, PARAMS_SMALL, PARAMS_110
    dev = "cuda"
    rng = np.random.RandomState(7)
    rows = []
    for params, label in ((PARAMS_TOY, "TOY"), (PARAMS_110, "110")):
        bk, sh = random_bk(params, 1, rng, dev)
        dec = torch.from_numpy(rng.randint(-params.halfBg, params.halfBg,
                                           size=(params.kpl, params.N, 8)).astype(np.int32)).to(dev)
        expect_equal(f"cmux_delta {label}", cmux.cmux_delta(dec, bk[0], sh[0], params),
                     cmux.cmux_delta_ref(dec, bk[0], sh[0], params))
        rows.append(f"cmux_delta {label} B=8")
    params = PARAMS_SMALL
    bk, sh = random_bk(params, params.n, rng, dev)
    for B in (3, 96):
        acc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(2, params.N, B))
                               .astype(np.int32)).to(dev)
        bara = torch.from_numpy(rng.randint(0, 2 * params.N, size=(params.n, B))
                                .astype(np.int32)).to(dev)
        expect_equal(f"blind_rotate_step SMALL B={B}",
                     cmux.blind_rotate_step(acc, bara[:1], bk[0], sh[0], params),
                     cmux.blind_rotate_step_ref(acc, bara[:1], bk[0], sh[0], params))
        expect_equal(f"blind_rotate_fused SMALL B={B}",
                     cmux.blind_rotate_fused(acc, bara, bk, sh, params),
                     cmux.blind_rotate_fused_ref(acc, bara, bk, sh, params))
        rows += [f"blind_rotate_step SMALL B={B}", f"blind_rotate_fused SMALL B={B}"]
    torch.cuda.synchronize()
    for r in rows:
        log(f"[kernels] {r}: byte-equal to plain (tolerance exact)")
    bk, sh = random_bk(params, params.n, rng, dev, layout="ntt")
    C = -(-(params.n + 1) // 128) * 128
    tks = torch.from_numpy(rng.randint(-128, 128, size=(24, params.N, 4 * C))
                           .astype(np.int8)).to(dev)
    for B in (1, 3, 64):
        acc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(B, 2, params.N))
                               .astype(np.int32)).to(dev)
        bara = torch.from_numpy(rng.randint(0, 2 * params.N, size=(params.n, B))
                                .astype(np.int32)).to(dev)
        check_k5(params, acc, bara, bk, sh, tks, "SMALL (random key)")
    return rows


def ks_inputs(params, B: int, rng, kind: str) -> torch.Tensor:
    """A rotated accumulator int32[2, N, B] on the card whose key-switch
    digits are random, all zero ("zero") or all nonzero ("full")."""
    N = params.N
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(2, N, B)).astype(np.int64)
    if kind == "zero":
        acc[0] = params.ks_prec_offset
        acc[0, 0] = -params.ks_prec_offset
    elif kind == "full":
        digs = rng.randint(1, params.ks_base, size=(N, B, params.ks_t))
        u = sum(digs[..., j].astype(np.int64) << (32 - (j + 1) * params.ks_basebit)
                for j in range(params.ks_t)) + 1
        xs = u - params.ks_prec_offset
        xs[1:] = -xs[1:]
        acc[0] = (xs + 2 ** 31) % 2 ** 32 - 2 ** 31
    return torch.from_numpy(acc.astype(np.int32)).cuda()


def check_keyswitch() -> int:
    """The key-switch kernel alone against keyswitch_ref, byte-equal, at
    PARAMS_SMALL and PARAMS_110 for every B of KS_CHECK: the arm the plan
    takes, then each arm forced, on random digits, on digits that are all
    zero and on digits that are all nonzero."""
    from tfhe_tpu_torch.ops import cmux
    from tfhe_tpu_torch.params import PARAMS_SMALL, PARAMS_110
    rng = np.random.RandomState(11)
    err = 0
    for params, label in ((PARAMS_SMALL, "PARAMS_SMALL"), (PARAMS_110, "PARAMS_110")):
        C = -(-(params.n + 1) // 128) * 128
        planes = params.ks_t * (params.ks_base - 1)
        tks = torch.from_numpy(rng.randint(-128, 128, size=(planes, params.N, 4 * C))
                               .astype(np.int8)).cuda()
        for B in KS_CHECK:
            for kind in ("random", "zero", "full"):
                acc_t = ks_inputs(params, B, rng, kind)
                want = cmux.keyswitch_ref(acc_t, tks, params)
                acc = cmux._acc_rows(acc_t, params)
                got = {
                    "planned arm": cmux.keyswitch(acc_t, tks, params),
                    "gather arm": cmux._launch_keyswitch(
                        acc, tks, params, plan=(0, cmux.gather_split(B, params.N))),
                    "tensor-core arm": cmux._launch_keyswitch(
                        acc, tks, params, plan=(1, cmux.mma_split(B, params.N, C))),
                }
                for arm, out in got.items():
                    err = max(err, expect_equal(f"keyswitch {label} B={B} {kind} digits, {arm}",
                                                out, want))
                if kind != "random":
                    count = 0 if kind == "zero" else params.N * params.ks_t
                    if not (want[1][1] == count).all():
                        raise AssertionError(f"keyswitch {label} {kind}: nonzero-digit count")
        log(f"[kernels] keyswitch {label} B={list(KS_CHECK)}, planned arm and both arms forced, "
            f"random / all-zero / all-nonzero digits: byte-equal to keyswitch_ref "
            f"(max |err| {err})")
    return err


def sweep_keyswitch(sk, acc_rot, smi: str) -> dict:
    """The key switch at PARAMS_110 on the reference's table and a really
    rotated accumulator, over KS_SWEEP: the kernel (planned arm, and each arm
    forced), the plain version, its bound, and the library's way: one
    torch._int_mm on a prebuilt one-hot matrix, and the whole
    core.bootstrap.key_switch route (one-hot construction, product,
    recombine). Kernel and library in turns: kernel, library, route, kernel."""
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    tks = cloud.ks_table_perm
    C = tks.shape[-1] // 4
    rows = {}
    for B in KS_SWEEP:
        acc_t = acc_rot[:, :, :B].contiguous()
        acc = cmux._acc_rows(acc_t, params)
        want = cmux.keyswitch_ref(acc_t, tks, params)
        err = expect_equal(f"keyswitch PARAMS_110 (reference keys) B={B}",
                           cmux.keyswitch(acc_t, tks, params), want)
        a_ext, b_ext = bs.sample_extract(acc_t.permute(2, 0, 1), params)
        onehot = bs.ks_onehot(a_ext, params)
        rows_p = max(32, -(-B // 8) * 8)
        onehot_p = torch.cat([onehot, onehot.new_zeros((rows_p - B, onehot.shape[1]))]).contiguous()
        cv = torch.zeros(B, dtype=torch.float32, device="cuda")
        reps = 20
        k1 = cuda_ms(lambda: cmux.keyswitch(acc_t, tks, params), reps)
        lib = cuda_ms(lambda: torch._int_mm(onehot_p, cloud.ks_table), reps)
        route = cuda_ms(lambda: bs.key_switch(a_ext, b_ext, cloud.ks_table, cv, params), reps)
        k2 = cuda_ms(lambda: cmux.keyswitch(acc_t, tks, params), reps)
        gather = cuda_ms(lambda: cmux._launch_keyswitch(
            acc, tks, params, plan=(0, cmux.gather_split(B, params.N))), reps)
        mma = cuda_ms(lambda: cmux._launch_keyswitch(
            acc, tks, params, plan=(1, cmux.mma_split(B, params.N, C))), reps)
        plain = cuda_ms(lambda: cmux.keyswitch_ref(acc_t, tks, params), 5)
        rows[B] = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": plain,
                   **bound(*keyswitch_work(acc_t, tks, params, want)), "library_ms": lib,
                   "library_route_ms": route, "gather_ms": gather, "mma_ms": mma}
        r = rows[B]
        log(f"[kernels] keyswitch sweep PARAMS_110 B={B}: kernel {k1:.4f} / {k2:.4f} ms "
            f"(gather arm {gather:.4f}, tensor-core arm {mma:.4f}), torch._int_mm {lib:.4f} ms, "
            f"key_switch route {route:.4f} ms, plain {plain:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']} ({smi})")
    return rows


def phase_kernels(sk, x, smi: str) -> dict:
    """K1-K4 at the PARAMS_110 batch-256 shapes: byte-equal to the plain
    versions on real keys and a real accumulator, timed, each beside its
    bound; the key switch alone (check_keyswitch, sweep_keyswitch); then K5
    (phase_k5)."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    check_small_kernels()
    check_keyswitch()
    acc, bara = bs._prepare_acc(x, gates.MU, cloud)
    acc_t, bara_t = acc.permute(1, 2, 0).contiguous(), bara.T.contiguous()
    bk, sh, tks = cloud.bk_rows, cloud.bk_rows_shoup, cloud.ks_table_perm
    dec = bs.gadget_decompose(acc, params).permute(1, 2, 0).contiguous()     # [kpl, N, B]
    acc_rot = cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params)
    ks_rows = sweep_keyswitch(sk, acc_rot, smi)
    ks_out = cmux.keyswitch_ref(acc_rot, tks, params)
    ks_bytes, ks_seconds = keyswitch_work(acc_rot, tks, params, ks_out)
    n, B = params.n, BATCH
    one_step = nbytes(bk[0], sh[0])
    # name: (kernel, plain, repeats, bytes moved, seconds of operations)
    calls = {
        "cmux_delta": (lambda: cmux.cmux_delta(dec, bk[0], sh[0], params),
                       lambda: cmux.cmux_delta_ref(dec, bk[0], sh[0], params), 20,
                       nbytes(dec, acc_t) + one_step, cmux_seconds(params, B, 1)),
        "blind_rotate_step": (
            lambda: cmux.blind_rotate_step(acc_t, bara_t[:1], bk[0], sh[0], params),
            lambda: cmux.blind_rotate_step_ref(acc_t, bara_t[:1], bk[0], sh[0], params), 20,
            2 * nbytes(acc_t) + nbytes(bara_t[:1]) + one_step, cmux_seconds(params, B, 1)),
        "blind_rotate": (lambda: cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params),
                         lambda: cmux.blind_rotate_fused_ref(acc_t, bara_t, bk, sh, params), 3,
                         2 * nbytes(acc_t) + nbytes(bara_t, bk, sh), cmux_seconds(params, B, n)),
        "blind_rotate_ks": (
            lambda: cmux.blind_rotate_ks_fused(acc_t, bara_t, bk, sh, tks, params),
            lambda: cmux.blind_rotate_ks_fused_ref(acc_t, bara_t, bk, sh, tks, params), 3,
            nbytes(acc_t, bara_t, bk, sh) + ks_bytes, cmux_seconds(params, B, n) + ks_seconds),
    }
    out = {}
    for name, (kern, plain, reps, moved, seconds) in calls.items():
        err = expect_equal(f"{name} 110 B={BATCH}", kern(), plain())
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, reps if reps > 3 else 1)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(moved, seconds), "library_ms": None, "shape": f"PARAMS_110 B={BATCH}"}
        log(f"[kernels] {name} PARAMS_110 B={BATCH}: byte-equal (max |err| {err}), "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {out[name]['bound_ms']:.4f} ms "
            f"by {out[name]['bound_by']} ({smi})")
    # K1 and K2 without the wrappers' layout copies: one launch of one step
    tab_dec = dec.permute(2, 0, 1).contiguous()
    delta = torch.empty((B, params.k + 1, params.N), dtype=torch.int32, device="cuda")
    form = cmux.blind_rotate_plan(params.N)
    tab = cmux._kernel_tables(params.N, params.halfBg, "cuda")
    for count in (B, 1):
        acc_rows, bara_b = cmux._acc_rows(acc_t[:, :, :count], params), bara_t[:1, :count].T.contiguous()
        k2 = cuda_ms(lambda: cmux._launch_rotate(acc_rows, bara_b, bk[0], sh[0], params), 50)
        k1 = cuda_ms(lambda: cmux.check(cmux.library().tfhe_cmux_delta(
            tab_dec.data_ptr(), bk[0].data_ptr(), sh[0].data_ptr(), tab.data_ptr(),
            delta.data_ptr(), count, params.N, *form, cmux._stream(delta))), 50)
        out["cmux_delta"][f"launch_only_ms_B{count}"] = k1
        out["blind_rotate_step"][f"launch_only_ms_B{count}"] = k2
        log(f"[kernels] one step without the wrapper's copies, PARAMS_110 B={count}: cmux_delta "
            f"{k1:.4f} ms, blind_rotate_step {k2:.4f} ms ({smi})")
    # and on the device's own clock: the wrappers above are bound by the host
    for name, needle in (("cmux_delta", "cmux_delta_kernel"),
                         ("blind_rotate_step", "blind_rotate_kernel")):
        out[name]["device_ms"] = ms = kernel_device_ms(calls[name][0], needle)
        log(f"[kernels] {name} PARAMS_110 B={B}: "
            + ("not measured" if ms is None else f"{ms:.4f} ms") +
            f" on the device (torch.profiler, the kernel alone) ({smi})")
    out["keyswitch"] = {**ks_rows[BATCH], "shape": f"PARAMS_110 B={BATCH}",
                        "by_batch": {str(b): r for b, r in ks_rows.items()}}
    check_large_batch(sk, x)
    check_ragged(sk, x)
    out["blind_rotate_fused_packed"] = phase_k5(sk, x, smi)
    out["blind_rotate"]["by_batch"] = {
        b: {"ms": r["k3_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        for b, r in out["blind_rotate_fused_packed"]["sweep"].items()}
    return out


def check_large_batch(sk, x) -> None:
    """K3 and K4 at the first batch from which the bootstrap gives them every
    batch, SMALL_BATCH_MAX + 1, and at LARGE_BATCH (several waves of blocks, an
    odd batch that leaves the last block one sample), byte-equal to their
    plain versions. The plain blind rotate runs once, on the larger batch (the
    smaller is its first samples); K4's plain version is keyswitch_ref of that
    accumulator (cmux.blind_rotate_ks_fused_ref)."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import lwe_concat
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    bk, sh, tks = cloud.bk_rows, cloud.bk_rows_shoup, cloud.ks_table_perm
    batches = sorted({bs.SMALL_BATCH_MAX + 1, LARGE_BATCH})
    t0 = time.time()
    xs = lwe_concat([x] * -(-batches[-1] // x.b.shape[0]))[:batches[-1]]
    acc, bara = bs._prepare_acc(xs, gates.MU, cloud)
    plain_all = cmux.blind_rotate_fused_ref(acc.permute(1, 2, 0).contiguous(),
                                            bara.T.contiguous(), bk, sh, params)
    err = 0
    for big in batches:
        acc_t, bara_t = acc[:big].permute(1, 2, 0).contiguous(), bara[:big].T.contiguous()
        plain_acc = plain_all[:, :, :big].contiguous()
        err = max(err, expect_equal(f"blind_rotate 110 B={big}",
                                    cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params),
                                    plain_acc))
        err = max(err, expect_equal(f"blind_rotate_ks 110 B={big}",
                                    cmux.blind_rotate_ks_fused(acc_t, bara_t, bk, sh, tks, params),
                                    cmux.keyswitch_ref(plain_acc, tks, params)))
    torch.cuda.synchronize()
    log(f"[kernels] blind_rotate and blind_rotate_ks PARAMS_110 B={batches} (SMALL_BATCH_MAX = "
        f"{bs.SMALL_BATCH_MAX}: every batch above it is theirs): byte-equal to plain "
        f"(max |err| {err}; {time.time() - t0:.1f} s)")


def check_ragged(sk, x) -> None:
    """Every form of the kernels that hold S samples a block (K1, K2, K3) at
    the batches that leave the last block short, B = 1, S - 1 and S + 1, and
    the planned form through K4, on the reference's keys: byte-equal to plain.
    The plain versions run once, on the largest of these batches."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    bk, sh, tks = cloud.bk_rows, cloud.bk_rows_shoup, cloud.ks_table_perm
    t0 = time.time()
    forms = [f for f in cmux.CMUX_FORMS if cmux.cmux_smem_bytes(params.N, *f) <= cmux.SMEM_MAX]
    err, held = 0, []
    batches = sorted({b for S, _ in forms for b in (1, S - 1, S + 1) if b > 0})
    acc, bara = bs._prepare_acc(x[:batches[-1]], gates.MU, cloud)
    acc_all, bara_all = acc.permute(1, 2, 0).contiguous(), bara.T.contiguous()
    dec_all = bs.gadget_decompose(acc, params).permute(1, 2, 0).contiguous()
    want_all = {"cmux_delta": cmux.cmux_delta_ref(dec_all, bk[0], sh[0], params),
                "blind_rotate_step": cmux.blind_rotate_step_ref(acc_all, bara_all[:1], bk[0], sh[0],
                                                                params),
                "blind_rotate": cmux.blind_rotate_fused_ref(acc_all, bara_all, bk, sh, params)}
    for B in batches:                   # the samples are independent: a batch is a prefix
        acc_t, bara_t = acc_all[:, :, :B].contiguous(), bara_all[:, :B].contiguous()
        dec = dec_all[:, :, :B].contiguous()
        want = {name: w[:, :, :B].contiguous() for name, w in want_all.items()}
        for form in forms:
            if B not in (1, form[0] - 1, form[0] + 1):
                continue
            got = {"cmux_delta": cmux.cmux_delta(dec, bk[0], sh[0], params, form=form),
                   "blind_rotate_step": cmux.blind_rotate_step(acc_t, bara_t[:1], bk[0], sh[0],
                                                               params, form=form),
                   "blind_rotate": cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params, form=form)}
            for name in want:
                err = max(err, expect_equal(f"{name} 110 B={B} form {form}", got[name], want[name]))
            held.append(f"B={B} {form}")
        err = max(err, expect_equal(
            f"blind_rotate_ks 110 B={B}", cmux.blind_rotate_ks_fused(acc_t, bara_t, bk, sh, tks, params),
            cmux.keyswitch_ref(want["blind_rotate"], tks, params)))
    torch.cuda.synchronize()
    log(f"[kernels] cmux_delta, blind_rotate_step, blind_rotate in every form (S samples a block, "
        f"key buffers) at ragged batches [{', '.join(held)}] and blind_rotate_ks in the planned "
        f"form: byte-equal to plain (max |err| {err}; {time.time() - t0:.1f} s)")


def phase_k5(sk, x, smi: str) -> dict:
    """K5 at PARAMS_110 on real keys: byte-equal at B = 1, 64, at the first
    batch of each cluster size's second wave and at the gate path's batch of
    256 (two waves of the cluster of 2), its time at B = 1 (the MAJ stages of
    a comparison) beside the plain version's and its bound, and the sweep of B
    beside K3, with each form of the kernel forced up to two waves of the
    largest."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import lwe_concat
    from tfhe_tpu_torch.ops import cmux, cmux_packed as cp
    params, cloud = sk.params, sk.cloud
    bk, sh, tks = cloud.bk_ntt, cloud.bk_ntt_shoup, cloud.ks_table_perm
    forms = {"4 CTAs": 4, "2 CTAs": 2}
    waves = {name: cp.samples_in_flight(params.N, cluster, torch.cuda.current_device())
             for name, cluster in forms.items()}
    log(f"[kernels] K5 samples in flight at PARAMS_110, by CTAs a sample: {waves}")
    err = 0
    for B in (1, 64, waves["4 CTAs"] + 1, waves["2 CTAs"] + 1, BATCH):
        acc, bara = bs._prepare_acc(x[:B], gates.MU, cloud)
        err = max(err, check_k5(params, acc, bara.T, bk, sh, tks, "PARAMS_110 (reference keys)"))
    acc, bara = bs._prepare_acc(x[:1], gates.MU, cloud)
    acc_p, acc_t, bara_t = packed(acc), acc.permute(1, 2, 0), bara.T
    ms = cuda_ms(lambda: cp.blind_rotate_fused_packed(acc_p, bara_t, bk, sh, params), 5)
    plain_ms = cuda_ms(lambda: cp.blind_rotate_fused_packed_ref(acc_p, bara_t, bk, sh, params), 1)
    ks_ms = cuda_ms(lambda: cp.blind_rotate_packed_ks_fused(acc_t, bara_t, bk, sh, tks, params), 5)
    limit = bound(2 * nbytes(acc_p) + nbytes(bara_t, bk, sh), cmux_seconds(params, 1, params.n))
    log(f"[kernels] blind_rotate_fused_packed PARAMS_110 B=1: kernel {ms:.3f} ms "
        f"({ms / params.n * 1e3:.3f} us per CMux step), plain {plain_ms:.3f} ms, bound "
        f"{limit['bound_ms']:.4f} ms by {limit['bound_by']}; with the key switch {ks_ms:.3f} ms "
        f"({smi})")
    xs = lwe_concat([x] * -(-max(SWEEP) // x.b.shape[0]))
    sweep = {}
    for B in SWEEP:
        acc, bara = bs._prepare_acc(xs[:B], gates.MU, cloud)
        acc_p, acc_t, bara_t = packed(acc), acc.permute(1, 2, 0), bara.T
        bara_b = bara.contiguous()
        k5 = cuda_ms(lambda: cp.blind_rotate_fused_packed(acc_p, bara_t, bk, sh, params), 3)
        forced = ""
        if B <= 2 * waves["2 CTAs"]:
            scratch = acc_p.clone()

            def form_ms(cluster):
                return cuda_ms(lambda: cp._launch_packed(scratch, bara_b, bk, sh, params,
                                                         cluster=cluster), 3)
            forced = " (" + ", ".join(f"{name} {form_ms(cluster):.3f}"
                                      for name, cluster in forms.items()) + ")"
        k3 = cuda_ms(lambda: cmux.blind_rotate_fused(acc_t, bara_t, cloud.bk_rows,
                                                     cloud.bk_rows_shoup, params), 3)
        rows3 = cmux._acc_rows(acc_t, params)
        k3_forms = ", ".join(
            f"{form} " + format(cuda_ms(lambda: cmux._launch_rotate(
                rows3, bara_b, cloud.bk_rows, cloud.bk_rows_shoup, params, form), 3), ".3f")
            for form in cmux.CMUX_FORMS
            if cmux.cmux_smem_bytes(params.N, *form) <= cmux.SMEM_MAX)
        k5ks = cuda_ms(lambda: cp.blind_rotate_packed_ks_fused(acc_t, bara_t, bk, sh, tks,
                                                               params), 3)
        k4 = cuda_ms(lambda: cmux.blind_rotate_ks_fused(acc_t, bara_t, cloud.bk_rows,
                                                        cloud.bk_rows_shoup, tks, params), 3)
        work = bound(2 * nbytes(acc_t) + nbytes(bara_t, bk, sh), cmux_seconds(params, B, params.n))
        route = "K5" if bs.small_batch(B) else "K3/K4"
        taken, other = (k5ks, k4) if bs.small_batch(B) else (k4, k5ks)
        if taken > ROUTE_SLACK * other:
            raise AssertionError(f"B={B}: small_batch() routes to {route}, {taken:.3f} ms with the "
                                 f"key switch, but the other kernel takes {other:.3f} ms")
        sweep[B] = {"k5_ms": k5, "k3_ms": k3, "k5_ks_ms": k5ks, "k4_ms": k4, "route": route, **work}
        log(f"[kernels] sweep PARAMS_110 B={B}: K5 {k5:.3f} ms{forced}, K3 {k3:.3f} ms (forms, "
            f"(samples a block, key buffers): {k3_forms}); K5 + key switch {k5ks:.3f} ms, "
            f"K4 {k4:.3f} ms; the bootstrap takes {route}; bound of the blind rotate {work['bound_ms']:.3f} ms by "
            f"{work['bound_by']}: K5 at {100 * work['bound_ms'] / k5:.1f} %, K3 at "
            f"{100 * work['bound_ms'] / k3:.1f} % ({smi})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **limit, "library_ms": None,
            "us_per_step": ms / params.n * 1e3, "shape": "PARAMS_110 B=1",
            "sweep": {str(b): r for b, r in sweep.items()}}


def _hash(ct) -> str:
    return hashlib.sha256(ct.a.cpu().numpy().astype("<i4").tobytes()
                          + ct.b.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def check_and(sk, label: str, x, y, want_bits) -> None:
    """AND of a batch through the fused and the split route: decrypts to
    a & b, finite cv of the right shape, both routes the same samples."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import config, gates
    fused = gates.AND(x, y, sk.cloud)
    with config.overrides(TFHE_TPU_FUSEKS="0"):
        split = gates.AND(x, y, sk.cloud)
    got = tt.decrypt_bits(sk, fused)
    B = x.b.shape[0]
    if not np.array_equal(got, want_bits):
        raise AssertionError(f"{label}: AND does not decrypt to a & b")
    if fused.a.shape != (B, sk.params.n) or not torch.isfinite(fused.cv).all():
        raise AssertionError(f"{label}: AND output has the wrong shape or a non-finite cv")
    if not (torch.equal(fused.a, split.a) and torch.equal(fused.b, split.b)):
        raise AssertionError(f"{label}: fused and split routes differ")
    log(f"[main] AND PARAMS_110 B={B}: decrypts to a & b ({int(got.sum())} ones); fused route "
        f"== split route (blind rotate, then the int8 matmul key switch): a, b identical")


def phase_main(sk, golden_in, x, y, bits_x, bits_y) -> dict:
    """The gate path on the card: the batch-256 AND, fused and split routes,
    and the golden 8-input AND; then a batch one above SMALL_BATCH_MAX. Each
    takes the kernels bootstrap.small_batch() picks for its size. Returns each
    run's launch counts."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import lwe_concat
    from tfhe_tpu_torch.ops import cmux
    cloud = sk.cloud
    cmux.reset_launches()
    check_and(sk, "batch 256", x, y, bits_x & bits_y)
    gx, gy = golden_in
    g_out = gates.AND(gx, gy, cloud)
    torch.cuda.synchronize()
    launches = dict(cmux.LAUNCHES)
    log(f"[main] launch counts, AND B={BATCH} and the golden AND: {launches}")
    with open(GOLDEN) as f:
        golden = json.load(f)
    want_bits = np.array(golden["x_bits"]) & np.array(golden["y_bits"])
    if not np.array_equal(tt.decrypt_bits(sk, g_out), want_bits):
        raise AssertionError("golden AND does not decrypt to x & y")
    digest = _hash(g_out)
    if digest != golden["sha256"]:
        raise AssertionError(f"golden AND SHA-256 {digest} != {golden['sha256']}")
    log(f"[main] golden 8-input AND matches tfhe_tpu's SHA-256 {digest}")
    # the golden AND (8 samples) takes K5; the batch takes what small_batch() says
    small = ("blind_rotate_fused_packed", "keyswitch")
    large = ("blind_rotate_ks_fused", "blind_rotate_fused", "keyswitch")
    for name in small + (() if bs.small_batch(BATCH) else large):
        if launches[name] < 1:
            raise AssertionError(f"the batch-{BATCH} AND and the golden AND did not launch {name}")

    big = bs.SMALL_BATCH_MAX + 1
    reps = -(-big // BATCH)
    xb, yb = lwe_concat([x] * reps)[:big], lwe_concat([y] * reps)[:big]
    cmux.reset_launches()
    check_and(sk, f"batch {big}", xb, yb, np.tile(bits_x & bits_y, reps)[:big])
    torch.cuda.synchronize()
    launches_big = dict(cmux.LAUNCHES)
    log(f"[main] launch counts, AND B={big} (one above SMALL_BATCH_MAX): {launches_big}")
    for name in large:
        if launches_big[name] < 1:
            raise AssertionError(f"the batch-{big} AND did not launch {name}")
    return {"and": launches, "large_batch": launches_big}


def plain_and(x, y, cloud):
    """The AND gate through the plain version of the fused kernel."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    t = gates._affine2(x, y, *gates.GATE_TABLE["AND"])
    acc, bara = bs._prepare_acc(t, gates.MU, cloud)
    r, ext = cmux.blind_rotate_ks_fused_ref(acc.permute(1, 2, 0), bara.T, cloud.bk_rows,
                                            cloud.bk_rows_shoup, cloud.ks_table_perm,
                                            cloud.params)
    return bs.finish_fused_ks(r, ext, cloud.params)


def phase_timing(sk, x, y, want, smi: str) -> dict:
    """AND chained CHAIN times on the batch (as bench.py times it), kernel
    route and plain route, host clock around synchronised work."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import gates
    out = {}
    for route, gate in (("kernel", lambda p, q: gates.AND(p, q, sk.cloud)),
                        ("plain", lambda p, q: plain_and(p, q, sk.cloud))):
        z = gate(x, y)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CHAIN):
            z = gate(z, y)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / CHAIN
        if not np.array_equal(tt.decrypt_bits(sk, z), want):
            raise AssertionError(f"chained AND ({route} route) does not decrypt to a & b")
        out[route] = {"ms_per_batch": dt * 1e3, "bootstraps_per_s": BATCH / dt}
        log(f"[timing] {route} route: AND x{CHAIN} chained, B={BATCH}: "
            f"{dt * 1e3:.3f} ms/batch, {BATCH / dt:.1f} bootstraps/s ({smi})")
    return out


def circuit_ops(x, y, xpos, ypos):
    """The reference's 16-bit Cipher API as (name, call, plaintext answer of
    (a, b)) on CipherInts x, y and their absolute values xpos, ypos (minimum
    takes positive operands)."""
    return [
        ("+", lambda: x + y, lambda a, b: a + b),
        ("-", lambda: x - y, lambda a, b: a - b),
        ("*", lambda: x * y, lambda a, b: a * b),
        (">", lambda: x > y, lambda a, b: (a > b).astype(np.int64)),
        ("eq", lambda: x.eq(y), lambda a, b: (a == b).astype(np.int64)),
        ("abs", lambda: x.abs(), lambda a, b: np.abs(a)),
        ("minimum", lambda: xpos.minimum(ypos), lambda a, b: np.minimum(np.abs(a), np.abs(b))),
        ("/", lambda: x / y, lambda a, b: np.trunc(a / b).astype(np.int64)),
    ]


def expect_plaintext(sk, label: str, out, truth, a, b, nbits: int) -> np.ndarray:
    """Decrypt an op's output (a CipherInt as a signed nbits integer, a
    comparison as a bit), hold it against truth(a, b) and return it."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    if hasattr(out, "ct"):
        got = arith.decrypt_int(sk, out.ct)
        want = np.asarray(truth(a, b), np.int64) & ((1 << nbits) - 1)
        want = np.where(want >> (nbits - 1), want - (1 << nbits), want)
    else:
        got, want = tt.decrypt_bits(sk, out).astype(np.int64), truth(a, b)
    if not np.array_equal(got, want):
        raise AssertionError(f"{label} decrypts to {got}, want {want}")
    return got


def phase_circuits(sk, smi: str) -> tuple:
    """The serial-circuit path: 16-bit CipherInt ops at one number per batch,
    PARAMS_110, the reference's keys on the card. Each op runs twice (the
    first run puts its index plans on the card) and the second is timed.
    Returns the launch counts of this phase and the two operands."""
    from tfhe_tpu_torch import ref_keygen
    from tfhe_tpu_torch.cipher import CipherInt
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.ops import cmux
    with open(GOLDEN_ADD16) as f:
        g = json.load(f)
    nb, cloud = g["nbits"], sk.cloud
    ref_keygen.keygen_raw(tuple(g["seed"]))      # restarts the reference's stream
    ca, cb = ref_keygen.encrypt_bits(sk.lwe_key, g["a_bits"] + g["b_bits"])

    def ct(a, b):
        return LweCiphertext(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                             torch.zeros(b.shape, dtype=torch.float32, device="cuda"))

    x, y = CipherInt(ct(ca[:nb], cb[:nb]), cloud), CipherInt(ct(ca[nb:], cb[nb:]), cloud)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    a, b = np.array(g["a"]), np.array(g["b"])
    xpos = CipherInt.encrypt(sk, np.abs(a), nb, gen, "cuda")
    if b < 0:
        raise ValueError("the golden's b must be positive: minimum takes it as it is")
    cmux.reset_launches()
    for name, call, truth in circuit_ops(x, y, xpos, y):
        before = dict(cmux.LAUNCHES)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = expect_plaintext(sk, f"{name} 16-bit", out, truth, a, b, nb)
        k5 = (cmux.LAUNCHES["blind_rotate_fused_packed"] - before["blind_rotate_fused_packed"]) // 2
        if k5 < 1:
            raise AssertionError(f"{name}: no stage went through blind_rotate_fused_packed")
        log(f"[circuits] {name} 16-bit PARAMS_110, one number: decrypts to the plaintext "
            f"answer {int(got)}, {ms:.3f} ms, {k5} launches of blind_rotate_fused_packed "
            f"({smi})")
        if name == "+":
            digest = _hash(out.ct)
            if digest != g["sha256"]:
                raise AssertionError(f"add16 SHA-256 {digest} != {g['sha256']}")
            log(f"[circuits] add16 matches tfhe_tpu's SHA-256 {digest}")
    torch.cuda.synchronize()
    launches = dict(cmux.LAUNCHES)
    log(f"[circuits] launch counts: {launches}")
    if launches["keyswitch"] < 1:
        raise AssertionError("no stage of the circuits went through the key-switch kernel")
    return launches, x, y


def phase_arms(x, y, smi: str) -> None:
    """What the key switch's gather arm is worth end to end: add16 (stages of
    2 samples) and div16 (stages of 1, 2, 16 and 32) with the planned arms
    and with the tensor-core arm forced at every batch (KS_GATHER_MAX = 0), in
    turns; wall ms, the least and the median of each turn."""
    from tfhe_tpu_torch.ops import cmux
    planned = cmux.KS_GATHER_MAX
    try:
        for name, call, reps in (("add16", lambda: x + y, 8), ("div16", lambda: x / y, 3)):
            for turn in (1, 2):
                for label, limit in (("planned arms", planned), ("tensor-core arm only", 0)):
                    cmux.KS_GATHER_MAX = limit
                    times = []
                    for _ in range(reps + 1):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    times = sorted(times[1:])
                    log(f"[circuits] {name} turn {turn}, key switch {label}: least "
                        f"{times[0]:.3f} ms, median {times[len(times) // 2]:.3f} ms of {reps} "
                        f"({smi})")
    finally:
        cmux.KS_GATHER_MAX = planned


def phase_circuits_plain() -> None:
    """The same ops at PARAMS_SMALL, 8-bit operands, batch 3: on the card
    (kernels) and on CPU copies of the keys and inputs (the plain route),
    byte for byte."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    from tfhe_tpu_torch.cipher import CipherInt
    nb = 8
    sk = tt.keygen(tt.PARAMS_SMALL, seed=8, device="cuda")
    cpu_cloud = sk.cloud.to("cpu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    a, b = np.array([-100, 37, 5]), np.array([23, -61, 5])
    cts = [arith.encrypt_int(sk, v, nb, gen, "cuda") for v in (a, b, np.abs(a), np.abs(b))]
    card = [CipherInt(c, sk.cloud) for c in cts]
    host = [CipherInt(c.to("cpu"), cpu_cloud) for c in cts]
    t0 = time.time()
    for (name, call, truth), (_, call_h, _) in zip(circuit_ops(*card), circuit_ops(*host)):
        out, plain = call(), call_h()
        expect_plaintext(sk, f"{name} PARAMS_SMALL", out, truth, a, b, nb)
        got, want = (out.ct, plain.ct) if hasattr(out, "ct") else (out, plain)
        if not (torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)):
            raise AssertionError(f"{name} PARAMS_SMALL: the card differs from the plain route")
    log(f"[circuits] +, -, *, >, eq, abs, minimum, / at PARAMS_SMALL, 8-bit, batch 3: "
        f"the card equals the plain route byte for byte ({time.time() - t0:.1f} s)")


def phase_profile(x, y, smi: str) -> None:
    """One 16-bit add under torch.profiler: device time by kernel, and the
    share of the device's span (first kernel start to last kernel end) in
    which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile
    _ = x + y                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _ = x + y
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.time_range.end - ev.time_range.start)
    if not spans:
        log("[profile] torch.profiler recorded no device event: idle share not measured")
        return
    spans.sort()
    busy, edge = 0.0, spans[0][0]
    for start, end in spans:
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    span = spans[-1][1] - spans[0][0]
    log(f"[profile] add16 PARAMS_110, one number: wall {wall_ms:.3f} ms under the profiler, device "
        f"span {span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f} % "
        f"({len(spans)} device events; {smi})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:6]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    log(f"[profile]   {sum(us for _, us in top[6:]) / 1e3:9.3f} ms  every other kernel "
        f"({len(top) - 6} names)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import ref_keygen
    from tfhe_tpu_torch.core.lwe import LweCiphertext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()

    t0 = time.time()
    sk = tt.keygen_reference(tt.PARAMS_110)       # the cloud key is built on the card
    if sk.cloud.bk_ntt.device.type != "cuda":
        raise AssertionError("keygen_reference did not put the cloud key on the card")
    with open(GOLDEN) as f:
        golden = json.load(f)
    ga, gb = ref_keygen.encrypt_bits(sk.lwe_key, golden["x_bits"] + golden["y_bits"])
    log(f"[main] reference keys at PARAMS_110 on the card in {time.time() - t0:.3f} s")

    def ct(a, b):
        return LweCiphertext(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(),
                             torch.zeros(b.shape, dtype=torch.float32, device="cuda"))

    ng = len(golden["x_bits"])
    golden_in = (ct(ga[:ng], gb[:ng]), ct(ga[ng:], gb[ng:]))
    rng = np.random.RandomState(2024)
    bits_x = rng.randint(0, 2, BATCH).astype(np.int32)
    bits_y = rng.randint(0, 2, BATCH).astype(np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    x = tt.encrypt_bits(sk, bits_x, gen, "cuda")
    y = tt.encrypt_bits(sk, bits_y, gen, "cuda")

    timed = phase_kernels(sk, x, dev["smi"])
    launches = phase_main(sk, golden_in, x, y, bits_x, bits_y)
    phase_timing(sk, x, y, bits_x & bits_y, dev["smi"])
    circuit_launches, cx, cy = phase_circuits(sk, dev["smi"])
    phase_arms(cx, cy, dev["smi"])
    phase_circuits_plain()
    phase_profile(cx, cy, dev["smi"])

    def counted(counter: str) -> dict:
        by_path = {"and": launches["and"][counter], "large_batch": launches["large_batch"][counter],
                   "circuits": circuit_launches[counter]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def on_paths(counter: str) -> dict:
        out = counted(counter)
        if out["launches"] < 1:
            raise AssertionError(f"no path launched {counter}")
        return out

    def off_paths(counter: str) -> dict:
        out = counted(counter)
        if out["launches"] != 0:
            raise AssertionError(f"{counter} is listed as off every path, but the paths "
                                 f"launched it: {out['launches_by_path']}")
        return out

    kernels = [
        {"name": "blind_rotate", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:555", **on_paths("blind_rotate_fused"),
         **timed["blind_rotate"]},
        {"name": "blind_rotate_ks", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:505", **on_paths("blind_rotate_ks_fused"),
         **timed["blind_rotate_ks"]},
        {"name": "blind_rotate_fused_packed", "route": "cuda", "source": SOURCE_SMALL,
         "replaces": "tfhe_tpu/ops/cmux_pallas_packed.py:283",
         **on_paths("blind_rotate_fused_packed"), **timed["blind_rotate_fused_packed"]},
        {"name": "keyswitch", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:398", **on_paths("keyswitch"),
         **timed["keyswitch"]},
    ]
    # kernels no path of the port launches (nor of tfhe_tpu's bootstrap): built,
    # held against their plain versions and timed all the same
    off_path = [
        {"name": "blind_rotate_step", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:321", **off_paths("blind_rotate_step"),
         **timed["blind_rotate_step"]},
        {"name": "cmux_delta", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:584", **off_paths("cmux_delta"),
         **timed["cmux_delta"]},
    ]
    log(json.dumps({"kernels": kernels, "off_path": off_path}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
