#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA GPU, or
of its sharded path on four.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py              # one card: phases 1-14
    python3 chip_smoke.py --cards 4    # four cards: phases 1, 2, 13 and 15

--cards 4 refuses a machine with fewer cards before any phase runs, and
skips the one-card phases, which the default run checks.

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
              (SMALL_BATCH_MAX + 1) and, on a few hundred rows of each batch
              (first, last, tile and wave borders, random), at the batches of
              phases 7 and 8: K4 at 272,000 and 69,632 samples, K3 and the
              key switch alone at 64,000, every sample a random ciphertext;
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
  6. circuits the serial-circuit path, eager (TFHE_TPU_CIRCUIT_JIT=0, as
              recorded before circuits were graphs): 16-bit CipherInt operands
              at one number per batch with the reference's keys at PARAMS_110; +, -,
              *, >, eq, abs, minimum and / must decrypt to the plaintext
              answer through K5 (launch counters), add16 must match the golden
              SHA-256 tfhe_tpu computed on the CPU, and each op's wall time
              is printed; add16 and div16 again with the key switch's
              tensor-core arm forced at every batch, in turns with the planned
              arms; then the same ops at PARAMS_SMALL on 8-bit operands
              of batch 3 must equal, byte for byte, the plain route (the same
              circuits on CPU tensors, where every wrapper takes its plain
              version);
  6b. graph   the same eight ops and vector_add / vector_mul / vector_sum at
              length 32 through arith.circuit's CUDA graphs (TFHE_TPU_CIRCUIT_JIT
              auto, graphs that capture on a key's second call): the first
              call eager, the second captures, then a replay on other
              operands; each byte-equal (a, b, cv) to the eager run on
              the same operands, with eager's launch counts, decrypting right;
              add16 against the golden SHA-256; capture ms, replay and eager
              wall ms in turns, the graphs held and their pools; add16 with the
              key switch's tensor-core arm forced as a graph of its own; the
              capture rule's sweep (an add of 1 to 128 numbers, replay beside
              eager, the pools); add16's idle share under replay
              (torch.profiler). The kernel nodes of every captured graph,
              read through libcuda by function name, must be the launches the
              wrappers counted during its capture, which each replay adds to
              the counters, and K5's must be cluster kernel nodes.
              The later phases run with the default graphs (auto; a key
              captured after arith.CAPTURE_AFTER eager calls) and print how
              many of their circuit calls repeat a key, were captured or
              replayed;
  7. linalg   encrypted vectors and matrices, 16-bit numbers, the same keys:
              vector_add, vector_mul and vector_sum at length 32, matmul and
              cannon_matmul at 8x8 (one AND batch of 69,632 samples, then every
              batch size on the way down) must decrypt to numpy's answer mod
              2^16, and the two matmuls alike; per op the wall time after a
              warm-up at 2x2, the launches and bootstrapped samples by kernel,
              samples/s beside the chained AND's, and the peak device memory;
  8. linreg   both linear regressions of 200 rows x 10 attributes as one
              batched fit each (the numerical one opens with AND batches of
              272,000 samples, the binary one with a MUX of 2 x 32,000): every
              (b1, b0) must equal a plaintext twin of the fixed-width circuit;
  9. apps     alice -> cloud -> verify over secret.key / cloud.key /
              cloud.data / answer.data in a temporary directory for add, mul
              and div at 16 bits; the reference's keys written by the port
              hash to tests/fixtures/SHA256SUMS; tests/fixtures/cloud.data
              imports, decrypts to (2017, 42) and its sum through the cloud
              app to 2059; the experiment suite (apps.cli) returns 0; then
              matmul, cannon_matmul and a 4-row regression at PARAMS_SMALL
              must equal the plain route byte for byte, and the 4-bit
              matmul / cannon_matmul / vector_sum must match the golden
              SHA-256 tfhe_tpu computed on the CPU;
 10. chunk    (after kernels) the bootstrap with its batch cap forced: 2,500
              samples in parts of 1,000 through K4 and the key switch, 250 in
              parts of 100 through K5, byte-equal to the unchunked calls; the
              cap this card derives;
 11. native   (after main) 8 samples through K5 and through K4, as the
              bootstrap takes them, against native_ref.bootstrap_batch (the
              reference's C++ engine on the host), byte-equal;
 12. noise    (after main) 4,096 AND gates at PARAMS_110 in batches of 256:
              failures (none allowed), |phase error| / (1/8) and the
              per-sample variance beside the noise models;
 13. parallel (after apps) parallel.dryrun at world 4, then the full-width
              shapes with the reference's keys (DP AND at B = 256, dp 2 x ks 2
              AND and XOR at B = 256, a 16-bit multiply one number a rank,
              Cannon 2x2 at 16 bits): each result decrypts right and equals
              this process's single-process result byte for byte; the ranks'
              launches and samples are the "parallel" path. On one card the
              four ranks share it over gloo and give no scaling number; with
              --cards 4 each rank has a card of its own, over NCCL; the lines
              name the backend the ranks report;
 14. profile  one 16-bit add (eager) and one 8x8 matmul under torch.profiler:
              device time by kernel and the device's idle share;
 15. cards4   (--cards 4 only) one rank a card over NCCL, every rank checking
              that it runs NCCL on cuda:rank, PARAMS_110 with the reference's
              keys on every card; each shape warmed, then timed once between
              barriers (the slowest rank's wall ms) beside one card's time
              for the same inputs on card 0, whose result every rank's must
              equal byte for byte (a, b; cv to rtol 1e-6), decrypting right:
              (b) DP AND at 16,384 (4,096 a card, K4), the all-gather alone;
              (c) the dp 2 x ks 2 and dp 1 x ks 4 AND at 1,024 (256 a card,
              K3, the key-switch table split over ks) beside DP AND at 1,024,
              their collectives alone; (d) a 16-bit multiply of 128 numbers,
              32 a card (K5); (e) Cannon 2x2 over NCCL point-to-point; (f) a
              16 x 16 16-bit matmul with a's rows sharded and b replicated
              (matmul_rows through sharded_circuit), against numpy; (g) the
              bootstrap of 4,456,448 samples (a 16-bit 32 x 32 matmul's
              opening AND) made on every card from one seed: 1,114,112 a card,
              above its cap, in two parts; each card's rows of wide_rows()
              against the plain version, every sample decrypted on the card;
              K3 and K5 against their plain versions on every card. The
              ranks' counts are the "cards4" path.

No phase catches a failure and goes on, and no app or wrapper moves to the
CPU or to a plain version on its own: the plain route runs only where a phase
asks for it, on CPU copies, to be compared with.

The line before the last is a JSON object with the path's kernels (the
"graph" path: the launches the [graph] phase's replays made, as the graphs
count them; with --cards 4 the "parallel" and "cards4" paths, each kernel's
max |err| on the four cards and no times); the last
line is {"ok": true, "device": {...}}. Without a CUDA card the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_and_golden.json")
GOLDEN_ADD16 = os.path.join(ROOT, "tests", "fixtures", "torch_port_add16_golden.json")
GOLDEN_LINALG = os.path.join(ROOT, "tests", "fixtures", "torch_port_linalg_golden.json")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
NBITS = 16             # the width of the linalg, linreg and apps phases
VECTOR = 32            # vector_add, vector_mul, vector_sum
MATRIX = 8             # matmul, cannon_matmul
LINREG_ROWS, LINREG_ATTRS = 200, 10
BATCH = 256
CHAIN = 5
SOURCE = "tfhe_tpu_torch/csrc/cmux.cu"
SOURCE_SMALL = "tfhe_tpu_torch/csrc/blind_rotate_small.cu"
# K5 beside K3: the waves of each (30 and 132 samples for K5's two forms, 264
# for K3 with two samples a block) and the batches between
SWEEP = (1, 2, 8, 30, 31, 64, 132, 133, 192, 264, 265, 396, 528, 660, 792, 1056, 1188, 1320,
         2048, 4096)
LARGE_BATCH = 2049     # K3 and K4 against plain at a batch of several waves
WIDE_RANDOM = 160      # random rows held against plain at the linalg and linreg batches
ROUTE_SLACK = 1.08     # the kernel small_batch() picks may be this much slower than the other
KS_CHECK = (1, 2, 3, 33, 64, 256)           # key switch against keyswitch_ref, both arms
KS_SWEEP = (1, 2, 8, 16, 24, 32, 64, 128, 256)   # key switch beside torch._int_mm
GRAPH_REPS = 5         # [graph]: replays and eager runs of each op, in turns
REPLAY_A, REPLAY_B = -3021, 4099        # [graph]: the replays' operands, unlike the capture's
GRAPH_SWEEP = (1, 4, 16, 32, 64, 128)   # [graph]: numbers of a 16-bit add, the capture rule
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


def device_events(prof) -> list:
    """The kernels and copies of a torch.profiler trace. The program's spans
    (``utils.profiling.span``, entered as record_function while a profiler
    records) are mirrored on the device's timeline as user annotations, from
    their first kernel to their last: they are no device work."""
    return [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


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
    spans = [ev.time_range.end - ev.time_range.start for ev in device_events(prof)
             if needle in ev.name]
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
    check_wide_batch(sk)
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


def wide_rows(B: int, N: int, rng: np.random.RandomState) -> np.ndarray:
    """Rows of a batch of B that the plain version is run on: the first and the
    last, the rows either side of each of the first borders of a key-switch
    tile (KS_MMA_ROWS samples), of a wave of blind-rotate blocks (S samples a
    block, one block a multiprocessor) and of the last such tile and wave, and
    WIDE_RANDOM rows drawn from the whole batch."""
    from tfhe_tpu_torch.ops import cmux
    S, _ = cmux.blind_rotate_plan(N)
    wave = S * torch.cuda.get_device_properties(0).multi_processor_count
    rows = {0, 1, B - 2, B - 1}
    for unit in (cmux.KS_MMA_ROWS, wave):
        for border in (unit, 2 * unit, B // unit * unit, (B - 1) // unit * unit):
            rows.update((border - 1, border, border + 1))
    rows.update(rng.randint(0, B, WIDE_RANDOM).tolist())
    return np.array(sorted(r for r in rows if 0 <= r < B), np.int64)


def check_wide_batch(sk) -> None:
    """The kernels at the batches the linalg and linreg phases give them,
    byte-equal to their plain versions on the rows of wide_rows() (the samples
    are independent: the plain version of a row needs that row alone): K4 at
    the opening AND batch of the numerical regression and of the 8x8 matmul,
    K3 and then the key-switch kernel alone at the binary regression's MUX.
    Every sample is its own random LWE ciphertext, so a row that came from
    another row's data cannot pass."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    bk, sh, tks = cloud.bk_rows, cloud.bk_rows_shoup, cloud.ks_table_perm
    products = NBITS * (NBITS + 1) // 2                 # ANDs of one 16-bit product
    fit = LINREG_ROWS * LINREG_ATTRS
    k4_batches = (fit * products, MATRIX ** 3 * products)
    mux = 2 * fit * NBITS
    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(69632)
    rng = np.random.RandomState(69632)
    top = max(k4_batches + (mux,))
    lo, hi = -(1 << 31), 1 << 31
    xs = LweCiphertext(
        torch.randint(lo, hi, (top, params.n), generator=gen, device="cuda").to(torch.int32),
        torch.randint(lo, hi, (top,), generator=gen, device="cuda").to(torch.int32),
        torch.zeros(top, dtype=torch.float32, device="cuda"))
    acc, bara = bs._prepare_acc(xs, gates.MU, cloud)
    acc_all, bara_all = acc.permute(1, 2, 0).contiguous(), bara.T.contiguous()
    del acc, bara, xs
    err, held = 0, []

    def inputs(B):
        # the last B samples: the batches below the largest do not share its rows
        return acc_all[:, :, top - B:].contiguous(), bara_all[:, top - B:].contiguous()

    def plain(acc_t, bara_t, rows):
        pick = torch.from_numpy(rows).cuda()
        rot = cmux.blind_rotate_fused_ref(acc_t[:, :, pick].contiguous(),
                                          bara_t[:, pick].contiguous(), bk, sh, params)
        return pick, rot, cmux.keyswitch_ref(rot, tks, params)

    for B in k4_batches:
        acc_t, bara_t = inputs(B)
        if cmux.keyswitch_plan(B, params.N, tks.shape[2] // 4) != (1, 1):
            raise AssertionError(f"key-switch plan at B={B}: "
                                 f"{cmux.keyswitch_plan(B, params.N, tks.shape[2] // 4)}")
        r, ext = cmux.blind_rotate_ks_fused(acc_t, bara_t, bk, sh, tks, params)
        pick, _, (want_r, want_ext) = plain(acc_t, bara_t, wide_rows(B, params.N, rng))
        err = max(err, expect_equal(f"blind_rotate_ks 110 B={B} r", r[pick], want_r),
                  expect_equal(f"blind_rotate_ks 110 B={B} ext", ext[:, pick], want_ext))
        held.append(f"blind_rotate_ks B={B} on {len(pick)} rows")
        del acc_t, bara_t, r, ext
    acc_t, bara_t = inputs(mux)
    rot = cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params)
    r, ext = cmux.keyswitch(rot, tks, params)
    pick, want_rot, (want_r, want_ext) = plain(acc_t, bara_t, wide_rows(mux, params.N, rng))
    err = max(err, expect_equal(f"blind_rotate 110 B={mux}", rot[:, :, pick], want_rot),
              expect_equal(f"keyswitch 110 B={mux} r", r[pick], want_r),
              expect_equal(f"keyswitch 110 B={mux} ext", ext[:, pick], want_ext))
    held.append(f"blind_rotate and keyswitch B={mux} on {len(pick)} rows")
    torch.cuda.synchronize()
    log(f"[kernels] the batches of the linalg and linreg phases, PARAMS_110, every sample a random "
        f"ciphertext of its own: {'; '.join(held)} (first, last, either side of the key-switch "
        f"tiles' and the waves' borders, {WIDE_RANDOM} random): byte-equal to plain "
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
    counts = read_counts()
    launches = counts["launches"]
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
    counts_big = read_counts()
    log(f"[main] launch counts, AND B={big} (one above SMALL_BATCH_MAX): "
        f"{counts_big['launches']}")
    expect_routes(f"the batch-{big} AND", counts_big, large)
    return {"and": counts, "large_batch": counts_big}


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
        want = signed(truth(a, b), nbits)
    else:
        got, want = tt.decrypt_bits(sk, out).astype(np.int64), truth(a, b)
    if not np.array_equal(got, want):
        raise AssertionError(f"{label} decrypts to {got}, want {want}")
    return got


def phase_circuits(sk, smi: str) -> tuple:
    """The serial-circuit path: 16-bit CipherInt ops at one number per batch,
    PARAMS_110, the reference's keys on the card. Each op runs twice (the
    first run puts its index plans on the card) and the second is timed.
    Returns the launch and sample counts of this phase and the two operands."""
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
    counts = read_counts()
    log(f"[circuits] launch counts: {counts['launches']}")
    expect_routes("the circuits", counts, ("keyswitch",))
    return counts, x, y


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


def expect_byte_equal(label: str, got, want) -> None:
    """a, b and cv of two ciphertexts identical."""
    for f in ("a", "b", "cv"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: {f} differs")


def wall_ms(call) -> float:
    """Host clock around call() between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def in_turns(call, reps: int) -> tuple:
    """Medians of `reps` eager (TFHE_TPU_CIRCUIT_JIT=0) and replayed (auto,
    a key already captured) wall ms of call(), taken in turns (eager, replay,
    replay, eager, ...)."""
    from tfhe_tpu_torch import config
    times = {"0": [], "auto": []}
    for i in range(reps):
        for flag in (("0", "auto") if i % 2 == 0 else ("auto", "0")):
            with config.overrides(TFHE_TPU_CIRCUIT_JIT=flag):
                times[flag].append(wall_ms(call))
    return tuple(sorted(v)[len(v) // 2] for v in (times["0"], times["auto"]))


def graph_run(label: str, call, call2, check, smi: str, digest=None) -> dict:
    """One op through arith.circuit's graphs (TFHE_TPU_CIRCUIT_JIT auto): call
    runs it on the capture's operands, call2 on others. The first call is the
    eager warm-up, the second captures and replays (equal to eager on its
    operands), then call2 replays (equal to eager there, check() on its
    output, the eager launch counts); the graph's kernel nodes against the
    launches it replays (check_graph_nodes); wall ms of the capture, and of
    replay and eager in turns. Returns the replay's counts."""
    from tfhe_tpu_torch import arith, config
    from tfhe_tpu_torch.ops import cmux

    def ct(out):
        return out.ct if hasattr(out, "ct") else out

    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        eager = ct(call())
        cmux.reset_launches()
        eager2 = ct(call2())
        torch.cuda.synchronize()
        eager_counts = read_counts()
    graphs, pool = arith.GRAPHS.graphs(), arith.GRAPHS.pool_bytes()
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="auto"):
        call()                                           # the warm-up
        if arith.GRAPHS.graphs() != graphs:
            raise AssertionError(f"[graph] {label}: the first call captured")
        captured = []
        capture_ms = wall_ms(lambda: captured.append(ct(call())))
        if arith.GRAPHS.graphs() != graphs + 1:
            raise AssertionError(f"[graph] {label}: the second call captured no graph")
        pool_bytes = arith.GRAPHS.pool_bytes() - pool
        cmux.reset_launches()
        out = call2()
        torch.cuda.synchronize()
        counts = read_counts()
        entry = next(reversed(arith.GRAPHS.entries.values()))    # call2's key, just used
    replayed = ct(out)
    expect_byte_equal(f"[graph] {label}, captured", captured[0], eager)
    expect_byte_equal(f"[graph] {label}, replayed on other operands", replayed, eager2)
    if counts != eager_counts:
        raise AssertionError(f"[graph] {label}: replay counts {counts} != eager {eager_counts}")
    if digest is not None and _hash(captured[0]) != digest:
        raise AssertionError(f"[graph] {label}: SHA-256 {_hash(captured[0])} != {digest}")
    got = check(out)
    nodes = check_graph_nodes(label, entry)
    eager_ms, replay_ms = in_turns(call2, GRAPH_REPS)
    log(f"[graph] {label} PARAMS_110: captured == eager and a replay on other operands == eager "
        f"(a, b, cv byte-equal; decrypts to {got}), launches == eager's "
        f"{ {k: v for k, v in counts['launches'].items() if v} }; capture (the second call) "
        f"{capture_ms:.3f} ms, replay {replay_ms:.3f} ms, eager {eager_ms:.3f} ms (medians of "
        f"{GRAPH_REPS} in turns); graphs held {arith.GRAPHS.graphs()}, this one's pool "
        f"{pool_bytes} bytes, all pools {arith.GRAPHS.pool_bytes()} bytes; {nodes} ({smi})")
    return counts


def phase_graph(sk, x, y, smi: str) -> dict:
    """Whole circuits as CUDA graphs (arith.circuit): the eight 16-bit
    CipherInt ops at one number and vector_add / vector_mul / vector_sum at
    length 32, PARAMS_110, the reference's keys, each through graph_run, add16
    against the golden SHA-256; add16 again with the key switch's tensor-core
    arm forced (KS_GATHER_MAX = 0), which must be a graph of its own; the
    capture rule's sweep; add16's idle share under replay. The phase's
    graphs capture on a key's second call and keep their CUDA graphs for
    check_graph_nodes; the default graphs come back after it. Returns the
    counts of the replays on other operands."""
    from tfhe_tpu_torch import arith

    class Kept(arith.CudaGraph):
        def __init__(self, device):
            super().__init__(device)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    default, arith.GRAPHS = arith.GRAPHS, arith.CircuitGraphs(Kept, eager_calls=1)
    try:
        return graph_ops(sk, x, y, smi)
    finally:
        arith.GRAPHS = default


def graph_ops(sk, x, y, smi: str) -> dict:
    """The ops of phase_graph, and its counts."""
    from tfhe_tpu_torch import arith, config, linalg
    from tfhe_tpu_torch.cipher import CipherInt
    from tfhe_tpu_torch.ops import cmux
    cloud, nb = sk.cloud, x.nbits
    with open(GOLDEN_ADD16) as f:
        golden = json.load(f)
    a, a2, b2 = np.array(golden["a"]), np.array(REPLAY_A), np.array(REPLAY_B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    xpos, x2, y2, xpos2 = (CipherInt.encrypt(sk, v, nb, gen, "cuda")
                           for v in (np.abs(a), a2, b2, np.abs(a2)))
    total = {"launches": {}, "samples": {}}
    for (name, call, truth), (_, call2, _) in zip(circuit_ops(x, y, xpos, y),
                                                  circuit_ops(x2, y2, xpos2, y2)):
        counts = graph_run(
            f"{name} {nb}-bit", call, call2,
            lambda out, t=truth, n=name: int(expect_plaintext(sk, f"[graph] {n}", out, t, a2, b2, nb)),
            smi, golden["sha256"] if name == "+" else None)
        add_counts(total, counts)

    rng = np.random.RandomState(61)
    va, vb, wa, wb = (rng.randint(0, 1 << NBITS, size=VECTOR).astype(np.int64) for _ in range(4))
    cva, cvb, cwa, cwb = (arith.encrypt_int(sk, v, NBITS, gen, "cuda") for v in (va, vb, wa, wb))

    def check_int(truth):
        def check(out):
            got = arith.decrypt_int(sk, out)
            if not np.array_equal(got, signed(truth, NBITS)):
                raise AssertionError(f"[graph] decrypts to {got}, want {signed(truth, NBITS)}")
            return f"numpy's answer mod 2^{NBITS}"
        return check

    for name, call, call2, truth in (
            ("vector_add", lambda: linalg.vector_add(cva, cvb, cloud),
             lambda: linalg.vector_add(cwa, cwb, cloud), wa + wb),
            ("vector_mul", lambda: linalg.vector_mul(cva, cvb, cloud),
             lambda: linalg.vector_mul(cwa, cwb, cloud), wa * wb),
            ("vector_sum", lambda: linalg.vector_sum(cva, cloud),
             lambda: linalg.vector_sum(cwa, cloud), wa.sum())):
        add_counts(total, graph_run(f"{name} length {VECTOR}", call, call2, check_int(truth), smi))

    planned = cmux.KS_GATHER_MAX
    held = arith.GRAPHS.graphs()
    cmux.KS_GATHER_MAX = 0
    try:
        graph_run(f"+ {nb}-bit, key switch's tensor-core arm forced", lambda: x + y,
                  lambda: x2 + y2, lambda out: int(arith.decrypt_int(sk, out.ct)), smi,
                  golden["sha256"])
    finally:
        cmux.KS_GATHER_MAX = planned
    if arith.GRAPHS.graphs() != held + 1:
        raise AssertionError("[graph] the forced arm did not capture a graph of its own")
    log(f"[graph] the tensor-core arm forced (KS_GATHER_MAX = 0) is a key and a graph of its own: "
        f"graphs held {held} -> {arith.GRAPHS.graphs()}, the planned arm's graph replays on")

    phase_graph_rule(sk, smi)
    phase_profile(f"add16 PARAMS_110, one number, replayed", lambda: x2 + y2, smi, tag="graph")
    return total


def phase_graph_rule(sk, smi: str) -> None:
    """The measurement behind the capture rule (arith.CAPTURE_MAX_BATCH): a
    16-bit add of L numbers (32 L input samples) eager and replayed in turns,
    with the rule lifted, and the pool each graph keeps."""
    from tfhe_tpu_torch import arith, config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(62)
    rng = np.random.RandomState(62)
    rule = arith.CAPTURE_MAX_BATCH
    arith.CAPTURE_MAX_BATCH = 1 << 30
    try:
        for L in GRAPH_SWEEP:
            p, q = (arith.encrypt_int(sk, rng.randint(-(1 << 15), 1 << 15, size=L), NBITS, gen,
                                      "cuda") for _ in range(2))
            pool, held = arith.GRAPHS.pool_bytes(), arith.GRAPHS.graphs()
            with config.overrides(TFHE_TPU_CIRCUIT_JIT="auto"):
                arith.add(p, q, sk.cloud)
                arith.add(p, q, sk.cloud)
            mine = "a new graph" if arith.GRAPHS.graphs() > held else "the graph of vector_add"
            eager_ms, replay_ms = in_turns(lambda: arith.add(p, q, sk.cloud), 3)
            log(f"[graph] capture rule: add {NBITS}-bit of {L} numbers ({2 * NBITS * L} input "
                f"samples; {'captured' if 2 * NBITS * L <= rule else 'eager'} under the rule of "
                f"{rule}): eager {eager_ms:.3f} ms, replay {replay_ms:.3f} ms "
                f"({100 * (1 - replay_ms / eager_ms):.1f} % less), {mine}, its pool "
                f"{arith.GRAPHS.pool_bytes() - pool} bytes ({smi})")
    finally:
        arith.CAPTURE_MAX_BATCH = rule


# The port's kernels by the name of their function, and the counter each
# launch of theirs adds one to (the key switch: one node of its arm and one
# of ks_finish_kernel per launch)
NODE_COUNTERS = {
    "blind_rotate_small_kernel": ("blind_rotate_fused_packed",),
    "blind_rotate_kernel": ("blind_rotate_fused", "blind_rotate_ks_fused", "blind_rotate_step"),
    "cmux_delta_kernel": ("cmux_delta",),
    "ks_gather_kernel": ("keyswitch",),
    "ks_mma_kernel": ("keyswitch",),
    "ks_finish_kernel": ("keyswitch",),
}


def mangled_words(name: str) -> list:
    """The names that open a C++ symbol's mangled name, outermost first
    (_ZN39_GLOBAL__N__..._cmux_cu_...19blind_rotate_kernelILi10E... gives the
    anonymous namespace and blind_rotate_kernel); a name that is not mangled,
    as it is."""
    if not name.startswith("_Z"):
        return [name]
    i, words = 2, []
    while i < len(name) and name[i] in "NL":         # nested; internal linkage
        i += 1
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        words.append(name[j:j + int(name[i:j])])
        i = j + int(name[i:j])
    return words


def graph_kernel_nodes(graph) -> tuple:
    """The kernel nodes of a CUDA graph kept after its capture
    (CUDAGraph(keep_graph=True)), read through libcuda (cuGraphGetNodes,
    cuGraphKernelNodeGetParams, cuFuncGetName / cuKernelGetName,
    cuGraphKernelNodeGetAttribute): their count by the port's kernel
    (NODE_COUNTERS; every other kernel under "other"), and the count of
    cluster kernel nodes by the kernel and the cluster's shape."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    P = ctypes.c_void_p

    class Params(ctypes.Structure):       # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", P), ("dims", ctypes.c_uint * 7), ("args", P), ("extra", P),
                    ("kern", P), ("ctx", P)]

    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    get_params.argtypes = [P, ctypes.POINTER(Params)]
    cu.cuGraphGetNodes.argtypes = [P, P, ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [P, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetAttribute.argtypes = [P, ctypes.c_int, P]
    cu.cuFuncGetName.argtypes = cu.cuKernelGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), P]

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"[graph] {what} returned CUresult {err}")

    g = P(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (P * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    by_kernel, clusters = {}, {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                          # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = Params(), ctypes.c_char_p()
        check(get_params(node, ctypes.byref(params)), "cuGraphKernelNodeGetParams")
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
        kernel = next((w for w in mangled_words(name.value.decode()) if w in NODE_COUNTERS),
                      "other")
        by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        value = (ctypes.c_uint * 16)()               # CUlaunchAttributeValue, 64 bytes
        check(cu.cuGraphKernelNodeGetAttribute(node, 4, value),   # CLUSTER_DIMENSION
              "cuGraphKernelNodeGetAttribute")
        dims = tuple(value[:3])
        if dims[0] * dims[1] * dims[2] > 1:
            clusters[(kernel, dims)] = clusters.get((kernel, dims), 0) + 1
    return by_kernel, clusters


def check_graph_nodes(label: str, entry) -> str:
    """The kernel nodes of a captured circuit's graph against the launches
    its capture counted, which every replay adds to cmux.LAUNCHES: for each
    of the port's kernels, as many nodes as launches of its counters
    (NODE_COUNTERS); as many ks_finish_kernel nodes as key-switch arm nodes;
    every cluster kernel node K5's. Returns what it read."""
    by_kernel, clusters = graph_kernel_nodes(entry.graph.graph)
    want = {}
    for kernel, counters in NODE_COUNTERS.items():
        want.setdefault(counters, 0)
        want[counters] += by_kernel.get(kernel, 0)
    launches = {c: sum(entry.launches[k] for k in c) for c in want}
    launches[("keyswitch",)] *= 2                    # its arm and ks_finish_kernel
    if want != launches or by_kernel.get("ks_finish_kernel", 0) != entry.launches["keyswitch"]:
        raise AssertionError(f"[graph] {label}: kernel nodes {by_kernel} disagree with the "
                             f"launches counted at its capture {entry.launches}")
    k5 = sum(v for (kernel, _), v in clusters.items() if kernel == "blind_rotate_small_kernel")
    if k5 != sum(clusters.values()) or k5 != by_kernel.get("blind_rotate_small_kernel", 0):
        raise AssertionError(f"[graph] {label}: cluster kernel nodes {clusters}, K5's kernel "
                             f"nodes {by_kernel.get('blind_rotate_small_kernel', 0)}")
    return (f"its kernel nodes read through libcuda {by_kernel} == the launches counted at "
            f"its capture, the cluster nodes {clusters}")


def log_circuit_calls(phase: str) -> None:
    """How the phase's decorated circuit calls went through the default
    graphs (arith.GRAPHS.counts since it was cleared)."""
    from tfhe_tpu_torch import arith
    c = arith.GRAPHS.counts
    keyed = c["first"] + c["eager"] + c["capture"] + c["replay"]
    log(f"[{phase}] circuit calls through arith.circuit: {keyed + c['over_rule']}, "
        f"{c['over_rule']} of them over the capture rule (eager); of the {keyed} under it, "
        f"{keyed - c['first']} repeat a key ({100 * (keyed - c['first']) / max(keyed, 1):.1f} %): "
        f"{c['eager']} more eager (CAPTURE_AFTER = {arith.CAPTURE_AFTER}), {c['capture']} "
        f"captures, {c['replay']} replays; graphs held {arith.GRAPHS.graphs()}")


def signed(v, nbits: int) -> np.ndarray:
    """Integers taken mod 2^nbits as signed nbits-bit numbers."""
    v = np.asarray(v, np.int64) & ((1 << nbits) - 1)
    return np.where(v >> (nbits - 1), v - (1 << nbits), v)


BLIND_ROTATES = ("blind_rotate_fused", "blind_rotate_ks_fused", "blind_rotate_fused_packed")


def read_counts() -> dict:
    """The launches and the samples they held since the last reset, by kernel."""
    from tfhe_tpu_torch.ops import cmux
    return {"launches": dict(cmux.LAUNCHES), "samples": dict(cmux.SAMPLES)}


def add_counts(total: dict, part: dict) -> None:
    for kind in ("launches", "samples"):
        for name, v in part[kind].items():
            total[kind][name] = total[kind].get(name, 0) + v


def on_card(fn) -> dict:
    """fn() on the card between synchronises, with the counts set to 0 just
    before and read just after: its result, wall ms, counts, and the peak of
    the device memory allocated during the call beside what was held before."""
    from tfhe_tpu_torch.ops import cmux
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    PHASE_PEAK[0] = max(PHASE_PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    cmux.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"out": out, "ms": ms, **read_counts(), "held_bytes": held,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def describe(run: dict, and_rate: float, smi: str) -> str:
    """One run of on_card() in words: time, samples by kernel, rate, memory."""
    samples = {k: v for k, v in run["samples"].items() if v}
    launches = {k: v for k, v in run["launches"].items() if v}
    boots = sum(run["samples"][k] for k in BLIND_ROTATES)
    return (f"{run['ms']:.3f} ms; {boots} bootstrapped samples, by kernel {samples} in launches "
            f"{launches}; {boots / run['ms'] * 1e3:.1f} samples/s (the chained AND at B={BATCH}: "
            f"{and_rate:.1f}/s); peak device memory {run['peak_bytes'] / 2 ** 20:.1f} MiB "
            f"({run['held_bytes'] / 2 ** 20:.1f} MiB held before the call) ({smi})")


# the largest peak on_card() read before its resets since the last log_peak()
PHASE_PEAK = [0]


def log_peak(phase: str, smi: str) -> None:
    """Prints the peak of the device memory allocated since the last such
    line, and starts the next interval."""
    total = torch.cuda.get_device_properties(0).total_memory
    peak = max(PHASE_PEAK[0], torch.cuda.max_memory_allocated())
    log(f"[{phase}] peak device memory allocated in this phase {peak / 2 ** 20:.1f} MiB of "
        f"{total / 2 ** 20:.1f} MiB ({smi})")
    PHASE_PEAK[0] = 0
    torch.cuda.reset_peak_memory_stats()


def expect_routes(label: str, counts: dict, names) -> None:
    for name in names:
        if counts["launches"][name] < 1:
            raise AssertionError(f"{label}: no stage went through {name}")


def phase_linalg(sk, and_rate: float, smi: str) -> tuple:
    """Encrypted vectors and matrices of 16-bit numbers at PARAMS_110 on the
    card, each op after a warm-up at 2x2, decrypted and held against numpy mod
    2^16. Returns the phase's counts and the two encrypted matrices."""
    from tfhe_tpu_torch import arith, linalg
    cloud = sk.cloud
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    rng = np.random.RandomState(32)

    def draw(*shape):
        return rng.randint(0, 1 << NBITS, size=shape).astype(np.int64)

    def enc(v):
        return arith.encrypt_int(sk, v, NBITS, gen, "cuda")

    small = enc(draw(2, 2))
    for fn in (linalg.vector_add, linalg.vector_mul, linalg.matmul, linalg.cannon_matmul):
        fn(small, small, cloud)
    linalg.vector_sum(small, cloud)
    va, vb, ma, mb = draw(VECTOR), draw(VECTOR), draw(MATRIX, MATRIX), draw(MATRIX, MATRIX)
    cva, cvb, cma, cmb = enc(va), enc(vb), enc(ma), enc(mb)
    ops = [
        ("vector_add", f"length {VECTOR}", lambda: linalg.vector_add(cva, cvb, cloud), va + vb),
        ("vector_mul", f"length {VECTOR}", lambda: linalg.vector_mul(cva, cvb, cloud), va * vb),
        ("vector_sum", f"length {VECTOR}", lambda: linalg.vector_sum(cva, cloud), va.sum()),
        ("matmul", f"{MATRIX}x{MATRIX}", lambda: linalg.matmul(cma, cmb, cloud), ma @ mb),
        ("cannon_matmul", f"{MATRIX}x{MATRIX}", lambda: linalg.cannon_matmul(cma, cmb, cloud),
         ma @ mb),
    ]
    total = {"launches": {}, "samples": {}}
    got = {}
    for name, size, call, truth in ops:
        run = on_card(call)
        got[name] = arith.decrypt_int(sk, run["out"])
        if not np.array_equal(got[name], signed(truth, NBITS)):
            raise AssertionError(f"{name} {size} decrypts to {got[name]}, want "
                                 f"{signed(truth, NBITS)}")
        add_counts(total, run)
        log(f"[linalg] {name} {size}, {NBITS}-bit, PARAMS_110: decrypts to numpy's answer mod "
            f"2^{NBITS}; {describe(run, and_rate, smi)}")
        if name.endswith("matmul"):
            if run["samples"]["blind_rotate_ks_fused"] < MATRIX ** 3 * (NBITS * (NBITS + 1) // 2):
                raise AssertionError(f"{name}: the partial products did not go through "
                                     f"blind_rotate_ks_fused")
            expect_routes(name, run, ("blind_rotate_ks_fused", "blind_rotate_fused_packed",
                                      "keyswitch"))
    if not np.array_equal(got["matmul"], got["cannon_matmul"]):
        raise AssertionError("matmul and cannon_matmul decrypt differently")
    log(f"[linalg] matmul and cannon_matmul {MATRIX}x{MATRIX} decrypt alike; counts of the "
        f"phase: {total}")
    return total, (cma, cmb)


def twin_div(num: int, den: int, nb: int) -> int:
    """Plaintext twin of arith.div: the width-limited restoring loop
    (Cipher.cpp:508-577), with its output for a zero divisor (the restore
    never fires: all quotient bits come out ones) and the sign-bit compare mod
    2^nb, then the conditional negate by the XOR of the signs."""
    m = (1 << nb) - 1
    num, den = int(signed(num, nb)), int(signed(den, nb))
    an, ad = abs(num) & m, abs(den) & m
    neg_b = (-ad) & m
    P, A = 0, an
    for _ in range(nb):
        P = ((P << 1) | (A >> (nb - 1))) & m
        A = (A << 1) & m
        temp = (P + neg_b) & m
        neg = (temp >> (nb - 1)) & 1
        A |= 1 - neg
        if not neg:
            P = temp
    q = (-A) & m if (num < 0) != (den < 0) else A
    return int(signed(q, nb))


def twin_linreg(xs: np.ndarray, ys: np.ndarray, nb: int, binary: bool) -> list:
    """Plaintext twin of apps.linreg on xs [attrs, rows] and ys [attrs, rows]:
    the same widths and truncation at every step; (b1, b0) per attribute."""
    n_rows = xs.shape[1]
    m = (1 << nb) - 1
    out = []
    for x, y in zip(xs.astype(np.int64), ys.astype(np.int64)):
        sx, sy = int(x.sum()) & m, int(y.sum()) & m
        sxy = int(np.where(x != 0, y, 0).sum()) & m if binary else int(((x * y) & m).sum()) & m
        sxx = sx if binary else int(((x * x) & m).sum()) & m
        num = (n_rows * sxy - sx * sy) & m
        den = (n_rows * sxx - sx * sx) & m
        b1 = twin_div(num, den, nb)
        b0 = twin_div((sy - b1 * sx) & m, n_rows & m, nb)
        out.append((b1, b0))
    return out


def phase_linreg(sk, and_rate: float, smi: str) -> dict:
    """Both regressions of LINREG_ROWS rows x LINREG_ATTRS attributes at 16
    bits and PARAMS_110 as one batched fit each, on 6-bit data drawn from
    np.random.RandomState(7) (the targets, the binary attributes, then the
    numerical ones); every (b1, b0) must equal the plaintext twin."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    from tfhe_tpu_torch.apps import linreg
    R, A, cloud = LINREG_ROWS, LINREG_ATTRS, sk.cloud
    rng = np.random.RandomState(7)
    ys = np.broadcast_to(rng.randint(0, 1 << 6, size=R), (A, R))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(92)
    total = {"launches": {}, "samples": {}}
    for variant in ("binary", "numerical"):
        binary = variant == "binary"
        xs = rng.randint(0, 2 if binary else 1 << 6, size=(A, R))
        cx = (tt.encrypt_bits(sk, xs.astype(np.int32), gen, "cuda") if binary
              else arith.encrypt_int(sk, xs, NBITS, gen, "cuda"))
        cy = arith.encrypt_int(sk, ys, NBITS, gen, "cuda")
        fit = linreg.linear_regression_binary if binary else linreg.linear_regression
        run = on_card(lambda: fit(cx, cy, cloud))
        b1, b0 = (arith.decrypt_int(sk, v) for v in run["out"])
        got = [(int(p), int(q)) for p, q in zip(b1, b0)]
        want = twin_linreg(xs, ys, NBITS, binary)
        if got != want:
            raise AssertionError(f"linreg {variant} {R}x{A}: decrypts to {got}, the plaintext "
                                 f"twin gives {want}")
        # the binary fit's MUX of 2 x 32,000 is the large bootstrap without key
        # switch; the numerical fit's MUXes (the divisions') are small
        expect_routes(f"linreg {variant}", run,
                      ("blind_rotate_ks_fused", "blind_rotate_fused_packed", "keyswitch")
                      + (("blind_rotate_fused",) if binary else ()))
        add_counts(total, run)
        log(f"[linreg] {variant} fit, {R} rows x {A} attributes, {NBITS}-bit, PARAMS_110: all "
            f"{A} (b1, b0) equal the plaintext twin {want[:3]}...; {describe(run, and_rate, smi)}")
    return total


def _sha256_sums() -> dict:
    with open(os.path.join(FIXTURES, "SHA256SUMS")) as f:
        return {name: digest for digest, name in (line.split() for line in f)}


def phase_apps(sk, smi: str) -> dict:
    """The apps over the reference wire format, on the card by default (no
    --device): alice -> cloud -> verify for add, mul and div at 16 bits; the
    reference's keys as the port writes them against the committed hashes;
    the committed cloud.data through the cloud app; the experiment suite (apps.cli)."""
    from tfhe_tpu_torch import io as tio
    from tfhe_tpu_torch.apps import alice, cli, cloud, verify
    from tfhe_tpu_torch.core.crypt import decrypt_bits
    from tfhe_tpu_torch.ops import cmux
    a, b = 1234, -567
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cmux.reset_launches()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        alice.main([str(a), str(b), "--dir", d])
        log(f"[apps] alice: keys and {NBITS}-bit a={a}, b={b} written in "
            f"{time.perf_counter() - t0:.3f} s ({smi})")
        for op, want in (("add", a + b), ("mul", a * b), ("div", int(a / b))):
            t0 = time.perf_counter()
            cloud.main(["--op", op, "--dir", d])
            got = verify.main(["--dir", d])
            if got != int(signed(want, NBITS)):
                raise AssertionError(f"apps {op}: verify prints {got}, want {signed(want, NBITS)}")
            log(f"[apps] alice -> cloud --op {op} -> verify: {got}, the plaintext result; cloud "
                f"and verify with their key imports {time.perf_counter() - t0:.3f} s ({smi})")

        sums = _sha256_sums()
        for name, export in (("secret.key", tio.export_secret_keyset),
                             ("cloud.key", tio.export_cloud_keyset)):
            with open(os.path.join(d, name), "wb") as f:
                export(f, sk)
            with open(os.path.join(d, name), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != sums[name]:
                raise AssertionError(f"{name} of the reference's keys hashes to {digest}, "
                                     f"tests/fixtures/SHA256SUMS has {sums[name]}")
        log("[apps] export_secret_keyset / export_cloud_keyset of keygen_reference(PARAMS_110) "
            "hash to the secret.key and cloud.key lines of tests/fixtures/SHA256SUMS")
        shutil.copy(os.path.join(FIXTURES, "cloud.data"), os.path.join(d, "cloud.data"))
        with open(os.path.join(d, "cloud.data"), "rb") as f:
            ct = tio.import_ciphertexts(f, 2 * NBITS, sk.params.n)
        if ct.a.device.type != "cuda":
            raise AssertionError("import_ciphertexts did not put the samples on the card")
        bits = decrypt_bits(sk, ct).astype(np.int64).reshape(2, NBITS)
        pair = [int(v) for v in (bits << np.arange(NBITS)).sum(-1)]
        if pair != [2017, 42]:
            raise AssertionError(f"tests/fixtures/cloud.data decrypts to {pair}, want [2017, 42]")
        cloud.main(["--op", "add", "--dir", d])
        got = verify.main(["--dir", d])
        if got != 2017 + 42:
            raise AssertionError(f"the fixture's sum through the cloud app decrypts to {got}")
        log(f"[apps] tests/fixtures/cloud.data imports on the card, decrypts to {pair}, and its "
            f"{NBITS}-bit sum through the cloud app to {got}")
    t0 = time.perf_counter()
    if cli.main([str(NBITS), "1234", "567", "4"]) != 0:
        raise AssertionError("apps.cli reports a wrong result")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[apps] cli 16 1234 567 4 returns 0 in {time.perf_counter() - t0:.3f} s; counts of the "
        f"phase: {counts} ({smi})")
    expect_routes("apps", counts, ("blind_rotate_fused_packed", "keyswitch"))
    return counts


def phase_linalg_plain() -> None:
    """matmul and cannon_matmul 2x2 at 8 bits and a 4-row regression at 6 bits,
    PARAMS_SMALL: on the card (kernels) and on CPU copies of the keys and
    inputs (the plain route), byte for byte, and decrypting right."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith, linalg
    from tfhe_tpu_torch.apps import linreg
    sk = tt.keygen(tt.PARAMS_SMALL, seed=9, device="cuda")
    cpu_cloud = sk.cloud.to("cpu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    a, b = np.array([[1, -2], [0, 3]]), np.array([[2, 1], [-1, 1]])
    x, y = np.array([[1, 2, 3, 0]]), np.array([[3, 5, 7, 1]])
    ca, cb = (arith.encrypt_int(sk, v, 8, gen, "cuda") for v in (a, b))
    cx, cy = (arith.encrypt_int(sk, v, 6, gen, "cuda") for v in (x, y))
    t0 = time.time()
    cases = [("matmul", linalg.matmul, (ca, cb), [signed(a @ b, 8)]),
             ("cannon_matmul", linalg.cannon_matmul, (ca, cb), [signed(a @ b, 8)]),
             ("linear_regression", linreg.linear_regression, (cx, cy),
              [[v] for v in twin_linreg(x, y, 6, False)[0]])]
    for name, fn, args, want in cases:
        out = fn(*args, sk.cloud)
        plain = fn(*(c.to("cpu") for c in args), cpu_cloud)
        outs, plains = (out, plain) if isinstance(out, tuple) else ((out,), (plain,))
        for got, ref, truth in zip(outs, plains, want, strict=True):
            if not (torch.equal(got.a.cpu(), ref.a) and torch.equal(got.b.cpu(), ref.b)):
                raise AssertionError(f"{name} PARAMS_SMALL: the card differs from the plain route")
            if not np.array_equal(arith.decrypt_int(sk, got), truth):
                raise AssertionError(f"{name} PARAMS_SMALL decrypts to "
                                     f"{arith.decrypt_int(sk, got)}, want {truth}")
    log(f"[apps] matmul and cannon_matmul 2x2 (8-bit) and a 4-row linear_regression (6-bit) at "
        f"PARAMS_SMALL: the card equals the plain route byte for byte ({time.time() - t0:.1f} s)")


def phase_linalg_golden(sk) -> None:
    """The 4-bit 2x2 matmul and cannon_matmul and the vector_sum of 4 on the
    golden's reference-encrypted operands must match the SHA-256 tfhe_tpu
    computed on the CPU."""
    from tfhe_tpu_torch import arith, linalg, ref_keygen
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    with open(GOLDEN_LINALG) as f:
        g = json.load(f)
    nb = g["nbits"]
    values = [np.asarray(g[k], np.int64) for k in ("matrix_a", "matrix_b", "vector")]
    bits = np.concatenate([((v[..., None] >> np.arange(nb)) & 1).reshape(-1) for v in values])
    ref_keygen.keygen_raw(tuple(g["seed"]))      # restarts the reference's stream
    a, b = ref_keygen.encrypt_bits(sk.lwe_key, bits.astype(np.int32))
    cts, at = [], 0
    for v in values:
        m, shape = v.size * nb, v.shape + (nb,)
        cts.append(LweCiphertext(
            torch.from_numpy(a[at:at + m].reshape(shape + (a.shape[-1],))).cuda(),
            torch.from_numpy(b[at:at + m].reshape(shape)).cuda(),
            torch.zeros(shape, dtype=torch.float32, device="cuda")))
        at += m
    ma, mb, vec = cts
    outs = (linalg.matmul(ma, mb, sk.cloud), linalg.cannon_matmul(ma, mb, sk.cloud),
            linalg.vector_sum(vec, sk.cloud))
    h = hashlib.sha256()
    for ct in outs:
        h.update(ct.a.cpu().numpy().astype("<i4").tobytes())
        h.update(ct.b.cpu().numpy().astype("<i4").tobytes())
    if h.hexdigest() != g["sha256"]:
        raise AssertionError(f"linalg golden SHA-256 {h.hexdigest()} != {g['sha256']}")
    for out, want in zip(outs, (g["product"], g["product"], g["sum"])):
        if not np.array_equal(arith.decrypt_int(sk, out), want):
            raise AssertionError(f"linalg golden decrypts to {arith.decrypt_int(sk, out)}")
    log(f"[apps] 4-bit 2x2 matmul, cannon_matmul and vector_sum of 4 match tfhe_tpu's SHA-256 "
        f"{h.hexdigest()}")


def random_samples(params, B: int, seed: int):
    """B random LWE samples on the card (a, b uniform, cv 0): every sample a
    ciphertext of its own."""
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lo, hi = -(1 << 31), 1 << 31
    return LweCiphertext(
        torch.randint(lo, hi, (B, params.n), generator=gen, device="cuda").to(torch.int32),
        torch.randint(lo, hi, (B,), generator=gen, device="cuda").to(torch.int32),
        torch.zeros(B, dtype=torch.float32, device="cuda"))


def expect_same_ct(label: str, got, want) -> None:
    """a and b byte-equal, cv equal to rtol 1e-6 (a float32 variance)."""
    if not (torch.equal(got.a.cpu(), want.a.cpu()) and torch.equal(got.b.cpu(), want.b.cpu())):
        raise AssertionError(f"{label}: a or b differ")
    if not torch.allclose(got.cv.cpu(), want.cv.cpu(), rtol=1e-6, atol=0.0):
        raise AssertionError(f"{label}: cv differs")


CHUNKS = ((2500, 1000), (250, 100))     # (batch, forced cap)


def phase_chunk(sk, smi: str) -> None:
    """The bootstrap of a batch above its cap, in parts: with the cap forced,
    2,500 samples in parts of 1,000 (K4 and the key switch) and 250 in parts
    of 100 (K5) must give the unchunked call's bytes; the launch counts show
    the parts and their kernels. Prints the cap this card derives."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    dev = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(dev).total_memory
    keys = (cloud.bk_ntt, cloud.bk_ntt_shoup, cloud.bk_rows, cloud.bk_rows_shoup,
            cloud.ks_table, cloud.ks_table_perm)
    key_bytes = sum(t.numel() * t.element_size() for t in keys)
    cap = bs.batch_cap(dev, cloud)
    log(f"[chunk] cap this card derives at PARAMS_110: {cap} samples a bootstrap call "
        f"(cmux.max_batch {cmux.max_batch(params.N)}; memory: ({total} - {key_bytes} bytes of "
        f"keys) / {bs.PEAK_BYTES_PER_SAMPLE} = {(total - key_bytes) // bs.PEAK_BYTES_PER_SAMPLE}) "
        f"({smi})")
    for B, forced in CHUNKS:
        x = random_samples(params, B, seed=B)
        bs.bootstrap(x, gates.MU, cloud)                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = bs.bootstrap(x, gates.MU, cloud)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        saved = bs.batch_cap
        bs.batch_cap = lambda device, cloud, forced=forced: forced
        try:
            cmux.reset_launches()
            t0 = time.perf_counter()
            parts = bs.bootstrap(x, gates.MU, cloud)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()["launches"]
        finally:
            bs.batch_cap = saved
        sizes = [min(forced, B - s) for s in range(0, B, forced)]
        want = {"blind_rotate_fused_packed": sum(bs.small_batch(b) for b in sizes),
                "blind_rotate_ks_fused": sum(not bs.small_batch(b) for b in sizes)}
        want["keyswitch"] = len(sizes)
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"[chunk] B={B} cap {forced}: launches {got}, want {want}")
        expect_same_ct(f"[chunk] B={B} in parts of {forced}", parts, whole)
        log(f"[chunk] bootstrap B={B} with the cap forced to {forced}: parts {sizes}, launches "
            f"{got}; byte-equal to the unchunked call ({ms:.3f} ms in parts, {whole_ms:.3f} ms "
            f"whole; {smi})")


def phase_native(sk, smi: str) -> None:
    """K5 and K4, as the port's bootstrap takes them, against the reference's
    C++ engine on the host (native_ref.bootstrap_batch) at PARAMS_110 on 8
    random samples: a and b byte-equal."""
    from tfhe_tpu_torch import gates, native_ref
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    t0 = time.perf_counter()
    native_ref.build()
    build_s = time.perf_counter() - t0
    x = random_samples(params, 8, seed=808)
    t0 = time.perf_counter()
    want_a, want_b = native_ref.bootstrap_batch(sk, x.a.cpu().numpy(), x.b.cpu().numpy(), gates.MU)
    host_s = time.perf_counter() - t0
    saved = bs.SMALL_BATCH_MAX
    for kernel, small_max in (("blind_rotate_fused_packed", saved), ("blind_rotate_ks_fused", 0)):
        bs.SMALL_BATCH_MAX = small_max            # 0: the batch takes K4
        try:
            cmux.reset_launches()
            out = bs.bootstrap(x, gates.MU, cloud)
            torch.cuda.synchronize()
        finally:
            bs.SMALL_BATCH_MAX = saved
        if cmux.LAUNCHES[kernel] != 1:
            raise AssertionError(f"[native] the bootstrap of 8 did not take {kernel}: "
                                 f"{dict(cmux.LAUNCHES)}")
        if not (np.array_equal(out.a.cpu().numpy(), want_a)
                and np.array_equal(out.b.cpu().numpy(), want_b)):
            raise AssertionError(f"[native] {kernel} differs from native_ref.bootstrap_batch")
        log(f"[native] bootstrap of 8 random samples through {kernel}: byte-equal to the "
            f"reference's C++ engine (native_ref.bootstrap_batch, {native_ref.num_threads()} "
            f"OpenMP threads, {host_s:.3f} s on the host; built in {build_s:.1f} s) ({smi})")


NOISE_GATES, NOISE_BATCH = 4096, 256


def phase_noise(sk, smi: str) -> dict:
    """NOISE_GATES real AND gates at PARAMS_110 in batches of NOISE_BATCH, after
    tools/noise_stats.py: failures (none allowed) and the decrypted phase's
    error relative to the +-1/8 target; its variance is the post-gate sample
    variance the noise models predict."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core.crypt import decrypt_phase
    from tfhe_tpu_torch.utils import phasesim
    params = sk.params
    rng = np.random.RandomState(42)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(42)
    mu = float(gates.MU)
    fails, errs, kernel_s = 0, [], 0.0
    for _ in range(NOISE_GATES // NOISE_BATCH):
        a = rng.randint(0, 2, size=NOISE_BATCH).astype(np.int32)
        b = rng.randint(0, 2, size=NOISE_BATCH).astype(np.int32)
        ca, cb = tt.encrypt_bits(sk, a, gen, "cuda"), tt.encrypt_bits(sk, b, gen, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gates.AND(ca, cb, sk.cloud)
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - t0
        want = a & b
        fails += int(np.sum(tt.decrypt_bits(sk, out) != want))
        errs.append(decrypt_phase(sk, out).astype(np.float64) - np.where(want != 0, mu, -mu))
    err = np.concatenate(errs)
    rel = np.abs(err) / mu
    var = float(np.mean((err / 2.0 ** 32) ** 2))
    models = {"average": phasesim.sample_var_average(params),
              "measured (tfhe_tpu's)": phasesim.SAMPLE_VAR_MEASURED_110,
              "tracked": phasesim.sample_var_tracked(params)}
    log(f"[noise] {NOISE_GATES} AND gates at PARAMS_110 in batches of {NOISE_BATCH}: {fails} "
        f"failures; |phase error| / (1/8): mean {rel.mean():.5f}, p99 "
        f"{np.percentile(rel, 99):.5f}, max {rel.max():.5f} (1.0 is the decision boundary); "
        f"{kernel_s:.3f} s of gates ({smi})")
    log(f"[noise] per-sample variance of the gate output {var:.4e} (sigma {np.sqrt(var):.4e} of "
        f"the torus, {np.sqrt(var) * 8:.5f} of 1/8), beside the models: "
        + ", ".join(f"{k} {v:.4e} (ratio {var / v:.3f})" for k, v in models.items()))
    if fails:
        raise AssertionError(f"[noise] {fails} of {NOISE_GATES} AND gates decrypt wrong")
    return {"failures": fails, "mean": float(rel.mean()), "p99": float(np.percentile(rel, 99)),
            "max": float(rel.max()), "variance": var}


PARALLEL_WORLD = 4
PARALLEL_MUL = 4          # 16-bit numbers of the whole-circuit multiply, one a rank


def cannon_schedule(a, b, cloud):
    """The schedule of parallel.cannon.cannon_matmul_mesh on the stacked
    [d, d] batch in one process: the skew, then d rounds of arith.mul and
    arith.add with the rows rolled left and the columns up by one between."""
    from tfhe_tpu_torch import arith
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    d = a.batch_shape[0]
    ii, jj = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")

    def take(ct, rows, cols):
        r, c = torch.from_numpy(rows).to(ct.b.device), torch.from_numpy(cols).to(ct.b.device)
        return LweCiphertext(ct.a[r, c], ct.b[r, c], ct.cv[r, c])

    a_sk, b_sk = take(a, ii, (jj + ii) % d), take(b, (ii + jj) % d, jj)
    acc = None
    for _ in range(d):
        prod = arith.mul(a_sk, b_sk, cloud)
        acc = prod if acc is None else arith.add(acc, prod, cloud)
        a_sk, b_sk = take(a_sk, ii, (jj + 1) % d), take(b_sk, (ii + 1) % d, jj)
    return acc


def timed_between_barriers(fn, device) -> tuple:
    """fn() started after a barrier of every rank (on this rank's card under
    NCCL) and synchronised: (result, wall ms)."""
    import torch.distributed as dist
    dist.barrier(device_ids=[device.index] if dist.get_backend() == "nccl" else None)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def expect_card_a_rank(rank: int, device) -> str:
    """The backend of this rank, which must be NCCL with rank r on cuda:r
    (--cards 4); raises otherwise."""
    import torch.distributed as dist
    backend = dist.get_backend()
    if backend != "nccl" or device != torch.device("cuda", rank):
        raise AssertionError(f"rank {rank}: backend {backend} on {device}; --cards {CARDS} "
                             f"takes NCCL with rank r on cuda:r")
    return backend


def parallel_rank(rank: int, world: int, device, inputs: dict, one_a_card: bool = False) -> dict:
    """One rank of the full-width [parallel] shapes: the reference's keys at
    PARAMS_110 on this rank's device, each shape run once to warm, then once
    timed between barriers with the launch counts set to 0 before. Returns
    the results (numpy), each shape's wall ms and the counts. one_a_card
    (--cards 4): the rank raises unless it runs NCCL on cuda:rank."""
    import torch.distributed as dist
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.ops import cmux
    from tfhe_tpu_torch.parallel.cannon import cannon_matmul_mesh, make_mesh2d
    from tfhe_tpu_torch.parallel.mesh import (make_mesh, make_mesh2d_dp_ks, sharded_circuit,
                                              sharded_gate2, sharded_gate2_tp_ks)
    if one_a_card:
        expect_card_a_rank(rank, device)
    sk = tt.keygen_reference(tt.PARAMS_110, device=device)
    cloud = sk.cloud
    ct = {k: LweCiphertext(*(torch.from_numpy(v).to(device) for v in arrs))
          for k, arrs in inputs.items()}
    mesh, dpks, grid = (make_mesh(world, device=device), make_mesh2d_dp_ks(2, 2, device=device),
                        make_mesh2d(2, device=device))
    shapes = {
        "dp AND": lambda: sharded_gate2("AND", ct["x"], ct["y"], cloud, mesh),
        "dp x ks AND": lambda: sharded_gate2_tp_ks("AND", ct["x"], ct["y"], cloud, dpks),
        "dp x ks XOR": lambda: sharded_gate2_tp_ks("XOR", ct["x"], ct["y"], cloud, dpks),
        "mul16": lambda: sharded_circuit(arith.mul, (ct["ma"], ct["mb"]), cloud, mesh),
        "cannon": lambda: cannon_matmul_mesh(ct["ca"], ct["cb"], cloud, grid),
    }
    for fn in shapes.values():
        fn()
    torch.cuda.synchronize(device)
    cmux.reset_launches()
    outs, ms = {}, {}
    for name, fn in shapes.items():
        out, ms[name] = timed_between_barriers(fn, device)
        outs[name] = tuple(v.cpu().numpy() for v in (out.a, out.b, out.cv))
    return {"out": outs, "ms": ms, "launches": dict(cmux.LAUNCHES),
            "samples": dict(cmux.SAMPLES), "backend": dist.get_backend(), "device": str(device)}


def backend_note(ranks: list) -> str:
    """Where the ranks ran, from what they report: one rank a card over NCCL,
    or several processes time-slicing one card over gloo."""
    backends = {r["backend"] for r in ranks}
    devices = [r["device"] for r in ranks]
    if backends == {"nccl"} and len(set(devices)) == len(ranks):
        return f"one rank a card (NCCL), {len(ranks)} cards: {', '.join(devices)}"
    return (f"{len(ranks)} processes sharing one H100 over {'/'.join(sorted(backends))}: "
            f"not a scaling number")


def phase_parallel(sk, x, y, bits_x, bits_y, smi: str, one_a_card: bool = False) -> dict:
    """parallel.dryrun at world PARALLEL_WORLD, then the full-width shapes,
    each decrypted and held against this process's single-process result on
    the same keys and inputs. The ranks take one card each where the machine
    has PARALLEL_WORLD cards (NCCL, --cards 4), else they share this card
    (gloo); the lines name the backend the ranks report. one_a_card (--cards
    4): the phase raises unless the dry run and every rank ran NCCL, rank r on
    cuda:r. Returns the ranks' summed counts."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith, gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    lines = dryrun.run(PARALLEL_WORLD, dryrun.dryrun_multichip)[0]
    for line in lines:
        log(f"[parallel] {line}")
    log(f"[parallel] parallel.dryrun {PARALLEL_WORLD}: {time.perf_counter() - t0:.1f} s of wall "
        f"time, process start and keys included ({smi})")
    if len(lines) != 6 or not all(line.endswith("values OK") for line in lines):
        raise AssertionError(f"[parallel] the dry run did not pass every shape: {lines}")
    if one_a_card and "(nccl on cuda:0)" not in lines[0]:
        raise AssertionError(f"[parallel] the dry run did not run over NCCL: {lines[0]}")

    params, cloud = sk.params, sk.cloud
    gen = torch.Generator(device="cuda")
    gen.manual_seed(606)
    rng = np.random.RandomState(606)
    va, vb = rng.randint(0, 1 << 16, size=(2, PARALLEL_MUL))
    mat_a, mat_b = rng.randint(0, 1 << 8, size=(2, 2, 2))
    enc = {"x": x, "y": y,
           "ma": arith.encrypt_int(sk, va, 16, gen, "cuda"),
           "mb": arith.encrypt_int(sk, vb, 16, gen, "cuda"),
           "ca": arith.encrypt_int(sk, mat_a, 16, gen, "cuda"),
           "cb": arith.encrypt_int(sk, mat_b, 16, gen, "cuda")}
    inputs = {k: tuple(v.cpu().numpy() for v in (c.a, c.b, c.cv)) for k, c in enc.items()}
    t0 = time.perf_counter()
    ranks = dryrun.run(PARALLEL_WORLD, parallel_rank, inputs, one_a_card)
    wall = time.perf_counter() - t0
    note = backend_note(ranks)
    from tfhe_tpu_torch.core.lwe import LweCiphertext

    def lwe(arrs):
        return LweCiphertext(*(torch.from_numpy(v).cuda() for v in arrs))

    worst_cv = bs._bootstrap_variance(params) + params.n_extract * params.ks_t * params.ks_stdev ** 2
    one = {"dp AND": gates.AND(x, y, cloud),
           "dp x ks AND": gates.AND(x, y, cloud),
           "dp x ks XOR": gates.XOR(x, y, cloud),
           "mul16": arith.mul(enc["ma"], enc["mb"], cloud),
           "cannon": cannon_schedule(enc["ca"], enc["cb"], cloud)}
    truth = {"dp AND": bits_x & bits_y, "dp x ks AND": bits_x & bits_y,
             "dp x ks XOR": bits_x ^ bits_y, "mul16": signed(va * vb, 16),
             "cannon": signed(mat_a @ mat_b, 16)}
    for name, want in one.items():
        got = lwe(ranks[0]["out"][name])
        for r in range(1, PARALLEL_WORLD):
            if not all(np.array_equal(g, w) for g, w in zip(ranks[r]["out"][name],
                                                             ranks[0]["out"][name])):
                raise AssertionError(f"[parallel] {name}: rank {r} returned another result")
        if name.startswith("dp x ks"):
            # the split key switch charges the worst-case cv (ks_finalize(nnz=None))
            want = LweCiphertext(want.a, want.b, torch.full_like(want.cv, worst_cv))
        expect_same_ct(f"[parallel] {name}", got, want)
        plain = (tt.decrypt_bits(sk, got) if name.startswith("dp")
                 else arith.decrypt_int(sk, got))
        if not np.array_equal(plain, truth[name]):
            raise AssertionError(f"[parallel] {name} decrypts to {plain}, want {truth[name]}")
        slowest = max(r["ms"][name] for r in ranks)
        log(f"[parallel] {name}, PARAMS_110, world {PARALLEL_WORLD}: decrypts right; every rank's "
            f"result byte-equal to the single-process one; {slowest:.3f} ms on the slowest rank "
            f"({note}; {smi})")
    total = {"launches": {}, "samples": {}}
    for r in ranks:
        add_counts(total, r)
    log(f"[parallel] the full-width shapes: {wall:.1f} s of wall time with process start and keys; "
        f"launches and samples over the ranks {total}")
    expect_routes("parallel", total, ("blind_rotate_fused_packed", "keyswitch"))
    return total


# ----------------------------------------------------------------- four cards

CARDS = 4                 # --cards 4: one rank a card over NCCL
CARDS_AND = 16384         # (b) DP AND, 4,096 a card through K4
CARDS_TP = 1024           # (c) dp x ks AND, 256 a card through K3 and the split table
CARDS_MUL = 128           # (d) 16-bit numbers of the whole-circuit multiply, 32 a card
CARDS_MATRIX = 16         # (f) 16 x 16 16-bit matmul, 4 rows of a a card
# (g) the opening AND of a 16-bit 32 x 32 matmul: 1,114,112 samples a card,
# above one card's cap, so every card bootstraps its share in parts
CARDS_WIDE = 32 ** 3 * NBITS * (NBITS + 1) // 2
CARDS_WIDE_SEED = 4456448
CHUNK_ROWS = 1 << 18      # samples a step when (g) encrypts and decrypts on the card
CARDS_REPEATS = 5         # (b), (c) and (g)'s gather timed again this often: their spread


def matmul_rows(a_rows, b_copies, cloud):
    """One rank's rows of a product: linalg.matmul of its rows of `a` by the
    whole of `b`, the copy of b it holds (the caller stacks one copy a rank
    along a new leading axis). With parallel.mesh.sharded_circuit this is the
    row-sharded matmul: a's rows and b's copies split over the ranks, every
    rank multiplies its rows by all of b, the rows gathered."""
    from tfhe_tpu_torch import linalg
    return linalg.matmul(a_rows, b_copies[0], cloud)


def encrypt_bits_on_card(sk, B: int, seed: int, device):
    """B random bits and their encryptions, made on `device` from one seeded
    generator, CHUNK_ROWS at a time (the key's dot product holds int64
    temporaries): every card given the same seed holds the same batch."""
    from tfhe_tpu_torch.core.crypt import _key, lwe_encrypt
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.numeric import mod_switch_to_torus32
    params = sk.params
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2, (B,), generator=gen, dtype=torch.int32, device=device)
    mu = mod_switch_to_torus32(1, 8, device=device)
    key = _key(sk, device)
    out = LweCiphertext(torch.empty((B, params.n), dtype=torch.int32, device=device),
                        torch.empty(B, dtype=torch.int32, device=device),
                        torch.empty(B, dtype=torch.float32, device=device))
    for s in range(0, B, CHUNK_ROWS):
        part = lwe_encrypt(torch.where(bits[s:s + CHUNK_ROWS] != 0, mu, -mu), key,
                           params.ks_stdev, gen)
        out.a[s:s + CHUNK_ROWS], out.b[s:s + CHUNK_ROWS] = part.a, part.b
        out.cv[s:s + CHUNK_ROWS] = part.cv
    return bits, out


def decrypt_bits_on_card(sk, ct) -> torch.Tensor:
    """The bits of a flat batch, decrypted on its card CHUNK_ROWS at a time."""
    from tfhe_tpu_torch.core.crypt import _key, lwe_phase
    key = _key(sk, ct.device)
    return torch.cat([(lwe_phase(ct[s:s + CHUNK_ROWS], key) > 0).to(torch.int32)
                      for s in range(0, ct.b.shape[0], CHUNK_ROWS)])


def plain_gate_bootstrap(x, cloud):
    """bootstrap(x, MU) through the plain versions of what the large-batch
    route launches: K4's blind rotate and its key switch."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params = cloud.params
    acc, bara = bs._prepare_acc(x, gates.MU, cloud)
    rot = cmux.blind_rotate_fused_ref(acc.permute(1, 2, 0).contiguous(), bara.T.contiguous(),
                                      cloud.bk_rows, cloud.bk_rows_shoup, params)
    r, ext = cmux.keyswitch_ref(rot, cloud.ks_table_perm, params)
    return bs.finish_fused_ks(r, ext, params)


def ct_digest(ct) -> list:
    """A cheap fingerprint of a ciphertext batch on its card (sums of a and b
    as int64 words, of cv in float64), to hold the ranks' 8.9 GB results
    against each other without moving them."""
    a = ct.a.reshape(-1)
    return [int(a[: a.numel() // 2 * 2].view(torch.int64).sum().item()),
            int(ct.b.to(torch.int64).sum().item()), float(ct.cv.double().sum().item())]


def tp_collectives(cloud, mesh, B: int):
    """The collectives of sharded_gate2_tp_ks on a batch of B, alone, on zeros
    of the shapes the gate sends: three all-gathers of the extracted samples
    over the ks row, the all-reduce of the partial key switches, the final
    gather of the outputs over the grid."""
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.parallel.mesh import _gather_ct, all_gather_cat, all_reduce_sum
    params, dev = cloud.params, mesh.device
    per, ks = B // mesh.size, mesh.shape[1]
    row = mesh.groups["ks"]
    for t in (torch.zeros((per, params.k * params.N), dtype=torch.int32, device=dev),
              torch.zeros(per, dtype=torch.int32, device=dev),
              torch.zeros(per, dtype=torch.float32, device=dev)):
        all_gather_cat(t, row, ks, mesh)
    all_reduce_sum(torch.zeros((per * ks, cloud.ks_table.shape[1]), dtype=torch.int32,
                               device=dev), row, mesh)
    mine = LweCiphertext(torch.zeros((per, params.n), dtype=torch.int32, device=dev),
                         torch.zeros(per, dtype=torch.int32, device=dev),
                         torch.zeros(per, dtype=torch.float32, device=dev))
    return _gather_ct(mine, mesh.group, mesh.size, mesh)


def cards_rank(rank: int, world: int, device, inputs: dict) -> dict:
    """One rank of [cards4], one rank a card over NCCL: the reference's keys at
    PARAMS_110 on this card; shapes (b)-(f) warmed once, then each timed once
    between barriers with the launch counts set to 0 before (b); the
    collectives of (b) and (c) alone; (g) built on this card from a seed,
    bootstrapped in this card's parts, its rows held against the plain version
    and every sample decrypted here; K3 and K5 against their plain versions;
    last (b), the (c) shapes and their collectives CARDS_REPEATS more times,
    their spread. Returns the (b)-(f) results (numpy), wall ms, (g)'s
    summary, the max |err| by kernel and the counts of (b)-(g)."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.ops import cmux
    from tfhe_tpu_torch.parallel.cannon import cannon_matmul_mesh, make_mesh2d
    from tfhe_tpu_torch.parallel.mesh import (_gather_ct, make_mesh, make_mesh2d_dp_ks,
                                              sharded_circuit, sharded_gate2,
                                              sharded_gate2_tp_ks)
    backend = expect_card_a_rank(rank, device)
    sk = tt.keygen_reference(tt.PARAMS_110, device=device)
    cloud = sk.cloud
    ct = {k: LweCiphertext(*(torch.from_numpy(v).to(device) for v in arrs))
          for k, arrs in inputs.items()}
    mesh = make_mesh(world, device=device)
    dp2ks2, dp1ks4 = (make_mesh2d_dp_ks(2, 2, device=device),
                      make_mesh2d_dp_ks(1, 4, device=device))
    grid = make_mesh2d(2, device=device)
    x1k, y1k = ct["x"][:CARDS_TP], ct["y"][:CARDS_TP]
    shapes = {
        f"(b) dp AND B={CARDS_AND}": lambda: sharded_gate2("AND", ct["x"], ct["y"], cloud, mesh),
        f"(c) dp AND B={CARDS_TP}": lambda: sharded_gate2("AND", x1k, y1k, cloud, mesh),
        f"(c) dp 2 x ks 2 AND B={CARDS_TP}": lambda: sharded_gate2_tp_ks("AND", x1k, y1k, cloud,
                                                                         dp2ks2),
        f"(c) dp 1 x ks 4 AND B={CARDS_TP}": lambda: sharded_gate2_tp_ks("AND", x1k, y1k, cloud,
                                                                         dp1ks4),
        f"(d) mul16 x{CARDS_MUL}": lambda: sharded_circuit(arith.mul, (ct["ma"], ct["mb"]),
                                                           cloud, mesh),
        "(e) cannon 2x2": lambda: cannon_matmul_mesh(ct["ca"], ct["cb"], cloud, grid),
        f"(f) matmul {CARDS_MATRIX}x{CARDS_MATRIX}": lambda: sharded_circuit(
            matmul_rows, (ct["fa"], ct["fb"]), cloud, mesh),
    }
    warm = dict(shapes)
    # (f) warms on 4 x 2 by 2 x 2, as [linalg] warms its matmuls at 2x2
    warm[f"(f) matmul {CARDS_MATRIX}x{CARDS_MATRIX}"] = lambda: sharded_circuit(
        matmul_rows, (ct["fa"][:world, :2], ct["fb"][:, :2, :2]), cloud, mesh)
    for fn in warm.values():
        fn()
    torch.cuda.synchronize(device)
    cmux.reset_launches()
    outs, ms = {}, {}
    for name, fn in shapes.items():
        out, ms[name] = timed_between_barriers(fn, device)
        outs[name] = tuple(v.cpu().numpy() for v in (out.a, out.b, out.cv))
    # the collectives alone, at the shapes (b) and (c) send
    per = CARDS_AND // world
    mine = LweCiphertext(*(torch.from_numpy(v[rank * per:(rank + 1) * per]).to(device)
                           for v in outs[f"(b) dp AND B={CARDS_AND}"]))
    collectives = {f"(b) gather B={CARDS_AND}": lambda: _gather_ct(mine, mesh.group, world, mesh),
                   f"(c) dp 2 x ks 2 collectives B={CARDS_TP}": lambda: tp_collectives(
                       cloud, dp2ks2, CARDS_TP),
                   f"(c) dp 1 x ks 4 collectives B={CARDS_TP}": lambda: tp_collectives(
                       cloud, dp1ks4, CARDS_TP)}
    for fn in collectives.values():
        fn()
    for name, fn in collectives.items():
        ms[name] = timed_between_barriers(fn, device)[1]
    wide = cards_wide(sk, rank, world, device, mesh)
    counts = read_counts()
    per_tp = CARDS_TP // world
    errs = cards_kernel_checks(sk, x1k[rank * per_tp:(rank + 1) * per_tp],
                               f"[cards4] card {rank}")
    errs["blind_rotate_ks_fused"] = errs["keyswitch"] = wide.pop("max_abs_err")
    again = {name: fn for name, fn in {**shapes, **collectives}.items()
             if name.startswith(("(b) dp AND", "(c)"))}
    spread = {name: [timed_between_barriers(fn, device)[1] for _ in range(CARDS_REPEATS)]
              for name, fn in again.items()}
    return {"out": outs, "ms": ms, "wide": wide, **counts, "max_abs_err": errs,
            "spread": spread, "backend": backend, "device": str(device)}


def cards_kernel_checks(sk, x, label: str) -> dict:
    """K3 on this card's share of (c), and K5 alone and with the key switch
    on 64 of those samples, against their plain versions on this card: the
    kernels (g) does not hold. Returns the max |err| by kernel (0)."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    acc, bara = bs._prepare_acc(x, gates.MU, cloud)
    acc_t, bara_t = acc.permute(1, 2, 0).contiguous(), bara.T.contiguous()
    bk, sh = cloud.bk_rows, cloud.bk_rows_shoup
    k3 = expect_equal(f"{label} blind_rotate B={x.b.shape[0]}",
                      cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params),
                      cmux.blind_rotate_fused_ref(acc_t, bara_t, bk, sh, params))
    k5 = check_k5(params, acc[:64], bara[:64].T, cloud.bk_ntt, cloud.bk_ntt_shoup,
                  cloud.ks_table_perm, label)
    return {"blind_rotate_fused": k3, "blind_rotate_fused_packed": k5}


def cards_wide(sk, rank: int, world: int, device, mesh, samples: int = CARDS_WIDE) -> dict:
    """(g) on this rank: `samples` made on the card from one seed,
    bootstrapped by sharded_bootstrap_step over the mesh, this card's share
    in parts of the cap it derives; the gather of the shares alone,
    CARDS_REPEATS times between barriers; this card's rows of wide_rows()
    (and either side of each part's border) held against the plain version,
    a and b exact; every sample decrypted on the card."""
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    from tfhe_tpu_torch.parallel.mesh import _gather_ct, sharded_bootstrap_step
    cloud, params = sk.cloud, sk.params
    t0 = time.perf_counter()
    bits, x = encrypt_bits_on_card(sk, samples, CARDS_WIDE_SEED, device)
    torch.cuda.synchronize(device)
    made_s = time.perf_counter() - t0
    per, cap = samples // world, bs.batch_cap(device, cloud)
    before = dict(cmux.LAUNCHES)
    torch.cuda.reset_peak_memory_stats(device)
    out, ms = timed_between_barriers(lambda: sharded_bootstrap_step(x, cloud, mesh), device)
    peak = torch.cuda.max_memory_allocated(device)
    parts = cmux.LAUNCHES["blind_rotate_ks_fused"] - before.get("blind_rotate_ks_fused", 0)
    mine = out[rank * per:(rank + 1) * per]
    gather_ms = [timed_between_barriers(lambda: _gather_ct(mine, mesh.group, world, mesh),
                                        device)[1] for _ in range(CARDS_REPEATS)]
    rng = np.random.RandomState(CARDS_WIDE_SEED + rank)
    rows = set(wide_rows(per, params.N, rng).tolist())
    for border in range(cap, per, cap):
        rows.update((border - 1, border, border + 1))
    rows = np.array(sorted(r for r in rows if 0 <= r < per), np.int64) + rank * per
    pick = torch.from_numpy(rows).to(device)
    t0 = time.perf_counter()
    want = plain_gate_bootstrap(x[pick], cloud)
    got = out[pick]
    err = expect_equal(f"[cards4] (g) rank {rank}: a and b on its rows", (got.a, got.b),
                       (want.a, want.b))
    if not torch.allclose(got.cv, want.cv, rtol=1e-6, atol=0.0):
        raise AssertionError(f"[cards4] (g) rank {rank}: cv differs from the plain version "
                             f"on its rows")
    plain_s = time.perf_counter() - t0
    wrong = int((decrypt_bits_on_card(sk, out) != bits).sum().item())
    return {"ms": ms, "gather_ms": gather_ms, "parts": parts, "cap": cap, "per_card": per,
            "peak_bytes": peak, "rows_held": len(rows), "plain_s": plain_s, "made_s": made_s,
            "decrypted_wrong": wrong, "digest": ct_digest(out), "in_digest": ct_digest(x),
            "max_abs_err": err}


def phase_cards4(sk, smi: str) -> dict:
    """[cards4]: shapes (b)-(g) with one rank a card over NCCL (cards_rank),
    each held against this process's single-process result on card 0 for the
    same inputs (a, b exact; cv to rtol 1e-6, the dp x ks cv the worst case
    that ks_finalize charges without digit counts) and decrypted; (f) against
    numpy; (g) on each card against the plain version and decrypted in full
    there. Prints the slowest rank's wall ms beside one card's. Returns the
    ranks' summed counts."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith, gates, linalg
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import LweCiphertext, lwe_stack
    from tfhe_tpu_torch.parallel import dryrun
    params, cloud = sk.params, sk.cloud
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096)
    rng = np.random.RandomState(4096)
    bits_x, bits_y = rng.randint(0, 2, size=(2, CARDS_AND)).astype(np.int32)
    va, vb = rng.randint(0, 1 << 16, size=(2, CARDS_MUL))
    mat_a, mat_b = rng.randint(0, 1 << 8, size=(2, 2, 2))
    fa, fb = rng.randint(0, 1 << 8, size=(2, CARDS_MATRIX, CARDS_MATRIX))
    enc = {"x": tt.encrypt_bits(sk, bits_x, gen, "cuda"),
           "y": tt.encrypt_bits(sk, bits_y, gen, "cuda"),
           "ma": arith.encrypt_int(sk, va, NBITS, gen, "cuda"),
           "mb": arith.encrypt_int(sk, vb, NBITS, gen, "cuda"),
           "ca": arith.encrypt_int(sk, mat_a, NBITS, gen, "cuda"),
           "cb": arith.encrypt_int(sk, mat_b, NBITS, gen, "cuda"),
           "fa": arith.encrypt_int(sk, fa, NBITS, gen, "cuda"),
           "fb1": arith.encrypt_int(sk, fb, NBITS, gen, "cuda")}
    enc["fb"] = lwe_stack([enc["fb1"]] * CARDS, axis=0)
    inputs = {k: tuple(v.cpu().numpy() for v in (c.a, c.b, c.cv))
              for k, c in enc.items() if k != "fb1"}
    torch.cuda.empty_cache()              # card 0 is rank 0's too
    t0 = time.perf_counter()
    ranks = dryrun.run(CARDS, cards_rank, inputs)
    wall = time.perf_counter() - t0
    note = backend_note(ranks)
    if not note.startswith("one rank a card (NCCL)"):
        raise AssertionError(f"[cards4] the ranks did not run one a card over NCCL: {note}")
    log(f"[cards4] {note}; {wall:.1f} s of wall time with process start, keys and (g) ({smi})")

    def lwe(arrs):
        return LweCiphertext(*(torch.from_numpy(v).cuda() for v in arrs))

    def one_card(fn, warm: bool = True) -> tuple:
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    x, y = enc["x"], enc["y"]
    worst_cv = bs._bootstrap_variance(params) + params.n_extract * params.ks_t * params.ks_stdev ** 2
    and_1k, and_1k_ms = one_card(lambda: gates.AND(x[:CARDS_TP], y[:CARDS_TP], cloud))
    tp_want = LweCiphertext(and_1k.a, and_1k.b, torch.full_like(and_1k.cv, worst_cv))
    and_all, and_all_ms = one_card(lambda: gates.AND(x, y, cloud))
    per = CARDS_AND // CARDS
    _, and_per_ms = one_card(lambda: gates.AND(x[:per], y[:per], cloud))
    mul, mul_ms = one_card(lambda: arith.mul(enc["ma"], enc["mb"], cloud))
    cannon, cannon_ms = one_card(lambda: cannon_schedule(enc["ca"], enc["cb"], cloud))
    linalg.matmul(enc["fa"][:2, :2], enc["fb1"][:2, :2], cloud)       # warm at 2x2
    prod, prod_ms = one_card(lambda: linalg.matmul(enc["fa"], enc["fb1"], cloud), warm=False)
    one = {f"(b) dp AND B={CARDS_AND}": (and_all, and_all_ms, bits_x & bits_y),
           f"(c) dp AND B={CARDS_TP}": (and_1k, and_1k_ms, (bits_x & bits_y)[:CARDS_TP]),
           f"(c) dp 2 x ks 2 AND B={CARDS_TP}": (tp_want, and_1k_ms,
                                                 (bits_x & bits_y)[:CARDS_TP]),
           f"(c) dp 1 x ks 4 AND B={CARDS_TP}": (tp_want, and_1k_ms,
                                                 (bits_x & bits_y)[:CARDS_TP]),
           f"(d) mul16 x{CARDS_MUL}": (mul, mul_ms, signed(va * vb, NBITS)),
           "(e) cannon 2x2": (cannon, cannon_ms, signed(mat_a @ mat_b, NBITS)),
           f"(f) matmul {CARDS_MATRIX}x{CARDS_MATRIX}": (prod, prod_ms,
                                                         signed(fa @ fb, NBITS))}
    for name, (want, one_ms, truth) in one.items():
        got = lwe(ranks[0]["out"][name])
        for r in range(1, CARDS):
            if not all(np.array_equal(g, w) for g, w in zip(ranks[r]["out"][name],
                                                             ranks[0]["out"][name])):
                raise AssertionError(f"[cards4] {name}: rank {r} returned another result")
        expect_same_ct(f"[cards4] {name}", got, want)
        plain = (tt.decrypt_bits(sk, got) if "AND" in name else arith.decrypt_int(sk, got))
        if not np.array_equal(plain, truth):
            raise AssertionError(f"[cards4] {name} decrypts to {plain}, want {truth}")
        slowest = max(r["ms"][name] for r in ranks)
        log(f"[cards4] {name}: decrypts right; every rank's result byte-equal to one card's; "
            f"{slowest:.3f} ms on the slowest of {CARDS} cards (ranks "
            f"{', '.join(format(r['ms'][name], '.3f') for r in ranks)}), one card "
            f"{one_ms:.3f} ms, {one_ms / slowest:.2f} x ({smi}; {CARDS} cards)")
    for name in ranks[0]["ms"]:
        if "gather" in name or "collectives" in name:
            log(f"[cards4] {name} alone: {max(r['ms'][name] for r in ranks):.3f} ms on the "
                f"slowest rank ({smi}; {CARDS} cards)")
    b_name = f"(b) dp AND B={CARDS_AND}"
    b_ms = max(r["ms"][b_name] for r in ranks)
    log(f"[cards4] (b) rates: {CARDS} cards {CARDS_AND / b_ms * 1e3:.1f} bootstraps/s; one card "
        f"{CARDS_AND / and_all_ms * 1e3:.1f}/s at B={CARDS_AND}, {per / and_per_ms * 1e3:.1f}/s "
        f"at B={per} ({and_per_ms:.3f} ms); the gather's share "
        f"{100 * max(r['ms'][f'(b) gather B={CARDS_AND}'] for r in ranks) / b_ms:.1f} % "
        f"({smi}; {CARDS} cards)")
    one_again = {CARDS_AND: lambda: gates.AND(x, y, cloud),
                 CARDS_TP: lambda: gates.AND(x[:CARDS_TP], y[:CARDS_TP], cloud)}
    one_times = {B: [one_card(fn, warm=False)[1] for _ in range(CARDS_REPEATS)]
                 for B, fn in one_again.items()}
    for name in ranks[0]["spread"]:
        four = [max(times) for times in zip(*(r["spread"][name] for r in ranks))]
        line = (f"[cards4] {name} spread, {CARDS_REPEATS} more runs: {CARDS} cards (slowest rank) "
                f"{', '.join(format(t, '.3f') for t in four)} ms")
        B = CARDS_AND if name.startswith("(b)") else CARDS_TP
        if "AND" in name:
            line += (f"; one card's AND at B={B} "
                     f"{', '.join(format(t, '.3f') for t in one_times[B])} ms")
        log(f"{line} ({smi}; {CARDS} cards)")
    wide = [r["wide"] for r in ranks]
    if len({json.dumps(w["in_digest"]) for w in wide}) != 1:
        raise AssertionError(f"[cards4] (g) the ranks built different inputs: {wide}")
    if len({json.dumps(w["digest"]) for w in wide}) != 1:
        raise AssertionError(f"[cards4] (g) the ranks gathered different results: {wide}")
    for r, w in enumerate(wide):
        if w["parts"] != -(-w["per_card"] // w["cap"]) or w["parts"] < 2:
            raise AssertionError(f"[cards4] (g) rank {r}: {w['parts']} parts of {w['per_card']} "
                                 f"samples at a cap of {w['cap']}")
        if w["decrypted_wrong"]:
            raise AssertionError(f"[cards4] (g) rank {r}: {w['decrypted_wrong']} samples "
                                 f"decrypt wrong")
        log(f"[cards4] (g) bootstrap B={CARDS_WIDE}, card {r}: {w['per_card']} samples in "
            f"{w['parts']} parts at its cap of {w['cap']}; {w['ms']:.3f} ms; peak device memory "
            f"{w['peak_bytes'] / 2 ** 20:.1f} MiB; byte-equal to the plain version on "
            f"{w['rows_held']} rows ({w['plain_s']:.1f} s); every sample of the {CARDS_WIDE} "
            f"decrypts right; input made on the card in {w['made_s']:.1f} s ({smi})")
    g_ms = max(w["ms"] for w in wide)
    log(f"[cards4] (g) {CARDS_WIDE} samples on {CARDS} cards: {g_ms:.3f} ms on the slowest, "
        f"{CARDS_WIDE / g_ms * 1e3:.1f} bootstraps/s ({smi}; {CARDS} cards)")
    g_gather = [max(times) for times in zip(*(w["gather_ms"] for w in wide))]
    log(f"[cards4] (g) gather of the {CARDS_WIDE} results alone, {CARDS_REPEATS} runs: "
        f"{', '.join(format(t, '.3f') for t in g_gather)} ms on the slowest rank, "
        f"{100 * min(g_gather) / g_ms:.2f}-{100 * max(g_gather) / g_ms:.2f} % of (g) "
        f"({smi}; {CARDS} cards)")
    total = {"launches": {}, "samples": {}}
    for r in ranks:
        add_counts(total, r)
    log(f"[cards4] launches and samples of (b)-(g) over the ranks {total}")
    expect_routes("cards4", total, BLIND_ROTATES + ("keyswitch",))
    total["max_abs_err"] = {k: max(r["max_abs_err"][k] for r in ranks)
                            for k in ranks[0]["max_abs_err"]}
    log(f"[cards4] the kernels against their plain versions on every card, max |err| by kernel "
        f"{total['max_abs_err']}")
    return total


def phase_profile(label: str, fn, smi: str, tag: str = "profile") -> None:
    """One fn() under torch.profiler: device time by kernel, and the share of
    the device's span (first kernel start to last kernel end) in which no
    kernel ran; lines tagged [tag]."""
    from tfhe_tpu_torch.utils.profiling import device_trace
    fn()                                        # warm
    torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        with device_trace(d) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace_bytes = os.path.getsize(os.path.join(d, "trace.json"))
    spans, by_name = [], {}
    for ev in device_events(prof):
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.time_range.end - ev.time_range.start)
    if not spans:
        log(f"[{tag}] {label}: torch.profiler recorded no device event: idle share not measured")
        return
    spans.sort()
    busy, edge = 0.0, spans[0][0]
    for start, end in spans:
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    span = spans[-1][1] - spans[0][0]
    log(f"[{tag}] {label}: wall {wall_ms:.3f} ms under the profiler, device "
        f"span {span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle {100 * (1 - busy / span):.1f} % "
        f"({len(spans)} device events, a trace of {trace_bytes} bytes; {smi})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:6]:
        log(f"[{tag}]   {us / 1e3:9.3f} ms  {name[:90]}")
    log(f"[{tag}]   {sum(us for _, us in top[6:]) / 1e3:9.3f} ms  every other kernel "
        f"({len(top) - 6} names)")


def parse_args(argv=None) -> argparse.Namespace:
    """The options; --cards beyond the cards visible is refused here, before
    any phase runs."""
    ap = argparse.ArgumentParser(description="Smoke run of tfhe_tpu_torch on the card.")
    ap.add_argument("--cards", type=int, default=1, choices=(1, CARDS),
                    help=f"1 (default): every one-card phase, [parallel] with the ranks "
                         f"sharing this card; {CARDS}: [device], [build], [parallel] and "
                         f"[cards4] with one rank a card over NCCL")
    args = ap.parse_args(argv)
    visible = torch.cuda.device_count()
    if args.cards > visible:
        ap.error(f"--cards {args.cards} needs {args.cards} cards; {visible} visible")
    return args


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    args = parse_args(argv)
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import config, ref_keygen
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
    if args.cards == CARDS:
        return main_cards(sk, x, y, bits_x, bits_y, dev)

    timed = phase_kernels(sk, x, dev["smi"])
    log_peak("kernels", dev["smi"])
    phase_chunk(sk, dev["smi"])
    log_peak("chunk", dev["smi"])
    launches = phase_main(sk, golden_in, x, y, bits_x, bits_y)
    log_peak("main", dev["smi"])
    phase_native(sk, dev["smi"])
    phase_noise(sk, dev["smi"])
    log_peak("noise", dev["smi"])
    and_rate = phase_timing(sk, x, y, bits_x & bits_y, dev["smi"])["kernel"]["bootstraps_per_s"]
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):      # the eager path, as recorded
        circuit_counts, cx, cy = phase_circuits(sk, dev["smi"])
        phase_arms(cx, cy, dev["smi"])
        phase_circuits_plain()
    log_peak("circuits", dev["smi"])
    graph_counts = phase_graph(sk, cx, cy, dev["smi"])
    log_peak("graph", dev["smi"])
    from tfhe_tpu_torch import arith, linalg
    arith.GRAPHS.counts.clear()
    linalg_counts, (cma, cmb) = phase_linalg(sk, and_rate, dev["smi"])
    log_circuit_calls("linalg")
    log_peak("linalg", dev["smi"])
    arith.GRAPHS.counts.clear()
    linreg_counts = phase_linreg(sk, and_rate, dev["smi"])
    log_circuit_calls("linreg")
    log_peak("linreg", dev["smi"])
    arith.GRAPHS.counts.clear()
    apps_counts = phase_apps(sk, dev["smi"])
    log_circuit_calls("apps")
    phase_linalg_plain()
    phase_linalg_golden(sk)
    log_peak("apps", dev["smi"])
    parallel_counts = phase_parallel(sk, x, y, bits_x, bits_y, dev["smi"])
    log_peak("parallel", dev["smi"])
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        phase_profile("add16 PARAMS_110, one number", lambda: cx + cy, dev["smi"])
    phase_profile(f"matmul {MATRIX}x{MATRIX} {NBITS}-bit PARAMS_110",
                  lambda: linalg.matmul(cma, cmb, sk.cloud), dev["smi"])
    log_peak("profile", dev["smi"])

    paths = {"and": launches["and"], "large_batch": launches["large_batch"],
             "circuits": circuit_counts, "graph": graph_counts, "linalg": linalg_counts,
             "linreg": linreg_counts,
             "apps": apps_counts, "parallel": parallel_counts}
    log(kernels_line(paths, timed))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                           "count": torch.cuda.device_count()}}))
    return 0


def main_cards(sk, x, y, bits_x, bits_y, dev: dict) -> int:
    """--cards 4: [parallel] and [cards4] with one rank a card over NCCL. The
    one-card phases are the default run's; the kernels line gives each
    kernel's launches on these paths and its max |err| against the plain
    version on the four cards, and leaves the times to the one-card run."""
    parallel_counts = phase_parallel(sk, x, y, bits_x, bits_y, dev["smi"], one_a_card=True)
    log_peak("parallel", dev["smi"])
    cards_counts = phase_cards4(sk, dev["smi"])
    log_peak("cards4", dev["smi"])
    errs = cards_counts.pop("max_abs_err")
    untimed = {"ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None, "timed_by": "the one-card run (python3 chip_smoke.py)"}
    timed = {name: {"max_abs_err": errs.get(counter), **untimed}
             for name, counter, _, _ in ON_PATH + OFF_PATH}
    log(kernels_line({"parallel": parallel_counts, "cards4": cards_counts}, timed))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                           "count": torch.cuda.device_count()}}))
    return 0


# (name in the kernels line, launch counter, source, the TPU kernel it replaces)
ON_PATH = (
    ("blind_rotate", "blind_rotate_fused", SOURCE, "tfhe_tpu/ops/cmux_pallas.py:555"),
    ("blind_rotate_ks", "blind_rotate_ks_fused", SOURCE, "tfhe_tpu/ops/cmux_pallas.py:505"),
    ("blind_rotate_fused_packed", "blind_rotate_fused_packed", SOURCE_SMALL,
     "tfhe_tpu/ops/cmux_pallas_packed.py:283"),
    ("keyswitch", "keyswitch", SOURCE, "tfhe_tpu/ops/cmux_pallas.py:398"),
)
# kernels no path of the port launches (nor of tfhe_tpu's bootstrap): built,
# held against their plain versions and timed all the same
OFF_PATH = (
    ("blind_rotate_step", "blind_rotate_step", SOURCE, "tfhe_tpu/ops/cmux_pallas.py:321"),
    ("cmux_delta", "cmux_delta", SOURCE, "tfhe_tpu/ops/cmux_pallas.py:584"),
)


def kernels_line(paths: dict, timed: dict) -> str:
    """The JSON line of the path's kernels: launches and samples by path
    (`paths`: each path's counts), then `timed[name]`; fails if a kernel of
    the path was launched on no path, or an off-path kernel on one."""
    def counted(counter: str) -> dict:
        by_path = {path: c["launches"].get(counter, 0) for path, c in paths.items()}
        samples = {path: c["samples"].get(counter, 0) for path, c in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path,
                "samples": sum(samples.values()), "samples_by_path": samples}

    kernels, off_path = [], []
    for name, counter, source, replaces in ON_PATH:
        out = counted(counter)
        if out["launches"] < 1:
            raise AssertionError(f"no path launched {counter}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        **out, **timed[name]})
    for name, counter, source, replaces in OFF_PATH:
        out = counted(counter)
        if out["launches"] != 0:
            raise AssertionError(f"{counter} is listed as off every path, but the paths "
                                 f"launched it: {out['launches_by_path']}")
        off_path.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         **out, **timed[name]})
    return json.dumps({"kernels": kernels, "off_path": off_path})

if __name__ == "__main__":
    sys.exit(main())
