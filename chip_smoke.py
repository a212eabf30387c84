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
              PARAMS_110 shapes of its path (K1, K3, K4: batch 256; K5, the
              small-batch blind rotate: batch 1) beside its plain version's;
              then K5 beside K3 over a sweep of batch sizes;
  4. main     the reference's keys at PARAMS_110 on the card; a batch of 256
              encrypted AND gates through the fused route must decrypt to
              a & b, through the kernels (launch counters), equal the split
              route, and match the golden SHA-256 that tfhe_tpu computed on
              the CPU for 8 reference-encrypted inputs;
  5. timing   AND chained 5 times on the batch of 256, kernel route and plain
              route, in ms per batch and bootstraps/s;
  6. circuits the serial-circuit path: 16-bit CipherInt operands at one
              number per batch with the reference's keys at PARAMS_110; +, -,
              *, >, eq, abs, minimum and / must decrypt to the plaintext
              answer through K5 (launch counters), add16 must match the golden
              SHA-256 tfhe_tpu computed on the CPU, and each op's wall time
              is printed; then the same ops at PARAMS_SMALL on 8-bit operands
              of batch 3 must equal, byte for byte, the plain route (the same
              circuits on CPU tensors, where every wrapper takes its plain
              version).

The line before the last is a JSON object with the path's kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA card the script exits
nonzero and prints no result.
"""
from __future__ import annotations

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
SWEEP = (1, 2, 8, 32, 64, 96, 128, 132, 264)   # K5 beside K3; 132/264: one/two waves


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


def phase_kernels(sk, x, smi: str) -> dict:
    """K1, K3 and K4 at the PARAMS_110 batch-256 shapes: byte-equal to the
    plain versions on real keys and a real accumulator, and timed; then K5
    (phase_k5)."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.ops import cmux
    params, cloud = sk.params, sk.cloud
    check_small_kernels()
    acc, bara = bs._prepare_acc(x, gates.MU, cloud)
    acc_t, bara_t = acc.permute(1, 2, 0), bara.T
    bk, sh, tks = cloud.bk_rows, cloud.bk_rows_shoup, cloud.ks_table_perm
    dec = bs.gadget_decompose(acc, params).permute(1, 2, 0)         # [kpl, N, B]
    calls = {
        "cmux_delta": (lambda: cmux.cmux_delta(dec, bk[0], sh[0], params),
                       lambda: cmux.cmux_delta_ref(dec, bk[0], sh[0], params)),
        "blind_rotate": (lambda: cmux.blind_rotate_fused(acc_t, bara_t, bk, sh, params),
                         lambda: cmux.blind_rotate_fused_ref(acc_t, bara_t, bk, sh, params)),
        "blind_rotate_ks": (
            lambda: cmux.blind_rotate_ks_fused(acc_t, bara_t, bk, sh, tks, params),
            lambda: cmux.blind_rotate_ks_fused_ref(acc_t, bara_t, bk, sh, tks, params)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        err = expect_equal(f"{name} 110 B={BATCH}", kern(), plain())
        reps = 20 if name == "cmux_delta" else 3
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 1 if name != "cmux_delta" else reps)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"[kernels] {name} PARAMS_110 B={BATCH}: byte-equal (max |err| {err}), "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out["blind_rotate_fused_packed"] = phase_k5(sk, x, smi)
    return out


def phase_k5(sk, x, smi: str) -> dict:
    """K5 at PARAMS_110 on real keys: byte-equal at B = 1 and 64, its time at
    B = 1 (the MAJ stages of a comparison) beside the plain version's, and
    the sweep of B beside K3."""
    from tfhe_tpu_torch import gates
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import lwe_concat
    from tfhe_tpu_torch.ops import cmux, cmux_packed as cp
    params, cloud = sk.params, sk.cloud
    bk, sh, tks = cloud.bk_ntt, cloud.bk_ntt_shoup, cloud.ks_table_perm
    err = 0
    for B in (1, 64):
        acc, bara = bs._prepare_acc(x[:B], gates.MU, cloud)
        err = max(err, check_k5(params, acc, bara.T, bk, sh, tks, "PARAMS_110 (reference keys)"))
    acc, bara = bs._prepare_acc(x[:1], gates.MU, cloud)
    acc_p, acc_t, bara_t = packed(acc), acc.permute(1, 2, 0), bara.T
    ms = cuda_ms(lambda: cp.blind_rotate_fused_packed(acc_p, bara_t, bk, sh, params), 5)
    plain_ms = cuda_ms(lambda: cp.blind_rotate_fused_packed_ref(acc_p, bara_t, bk, sh, params), 1)
    ks_ms = cuda_ms(lambda: cp.blind_rotate_packed_ks_fused(acc_t, bara_t, bk, sh, tks, params), 5)
    log(f"[kernels] blind_rotate_fused_packed PARAMS_110 B=1: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; with the key switch {ks_ms:.3f} ms ({smi})")
    xs = lwe_concat([x, x[:max(SWEEP) - x.b.shape[0]]])
    for B in SWEEP:
        acc, bara = bs._prepare_acc(xs[:B], gates.MU, cloud)
        acc_p, acc_t, bara_t = packed(acc), acc.permute(1, 2, 0), bara.T
        k5 = cuda_ms(lambda: cp.blind_rotate_fused_packed(acc_p, bara_t, bk, sh, params), 3)
        k3 = cuda_ms(lambda: cmux.blind_rotate_fused(acc_t, bara_t, cloud.bk_rows,
                                                     cloud.bk_rows_shoup, params), 3)
        k5ks = cuda_ms(lambda: cp.blind_rotate_packed_ks_fused(acc_t, bara_t, bk, sh, tks,
                                                               params), 3)
        k4 = cuda_ms(lambda: cmux.blind_rotate_ks_fused(acc_t, bara_t, cloud.bk_rows,
                                                        cloud.bk_rows_shoup, tks, params), 3)
        log(f"[kernels] sweep PARAMS_110 B={B}: K5 {k5:.3f} ms, K3 {k3:.3f} ms; "
            f"K5 + key switch {k5ks:.3f} ms, K4 {k4:.3f} ms ({smi})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _hash(ct) -> str:
    return hashlib.sha256(ct.a.cpu().numpy().astype("<i4").tobytes()
                          + ct.b.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def phase_main(sk, golden_in, x, y, bits_x, bits_y) -> dict:
    """The main path: batch-256 AND on the card, fused and split routes,
    plus the golden 8-input AND. Returns the launch counts of this phase."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import config, gates
    from tfhe_tpu_torch.ops import cmux
    cloud = sk.cloud
    cmux.reset_launches()
    fused = gates.AND(x, y, cloud)
    with config.overrides(TFHE_TPU_FUSEKS="0"):
        split = gates.AND(x, y, cloud)
    gx, gy = golden_in
    g_out = gates.AND(gx, gy, cloud)
    torch.cuda.synchronize()
    launches = dict(cmux.LAUNCHES)
    log(f"[main] launch counts: {launches}")

    got = tt.decrypt_bits(sk, fused)
    if not np.array_equal(got, bits_x & bits_y):
        raise AssertionError("batch-256 AND does not decrypt to a & b")
    if fused.a.shape != (BATCH, sk.params.n) or not torch.isfinite(fused.cv).all():
        raise AssertionError("AND output has the wrong shape or a non-finite cv")
    log(f"[main] AND PARAMS_110 B={BATCH}: decrypts to a & b ({int(got.sum())} ones)")
    if not (torch.equal(fused.a, split.a) and torch.equal(fused.b, split.b)):
        raise AssertionError("fused and split routes differ")
    log("[main] fused route (blind_rotate_ks kernel) == split route "
        "(blind_rotate kernel + int8 matmul key switch): a, b identical")
    with open(GOLDEN) as f:
        golden = json.load(f)
    want_bits = np.array(golden["x_bits"]) & np.array(golden["y_bits"])
    if not np.array_equal(tt.decrypt_bits(sk, g_out), want_bits):
        raise AssertionError("golden AND does not decrypt to x & y")
    digest = _hash(g_out)
    if digest != golden["sha256"]:
        raise AssertionError(f"golden AND SHA-256 {digest} != {golden['sha256']}")
    log(f"[main] golden 8-input AND matches tfhe_tpu's SHA-256 {digest}")
    if launches["blind_rotate_ks_fused"] < 1 or launches["blind_rotate_fused"] < 1:
        raise AssertionError("the main path did not launch the blind-rotate kernels")
    return launches


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


def phase_circuits(sk, smi: str) -> dict:
    """The serial-circuit path: 16-bit CipherInt ops at one number per batch,
    PARAMS_110, the reference's keys on the card. Each op runs twice (the
    first run puts its index plans on the card) and the second is timed.
    Returns the launch counts of this phase."""
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
    return launches


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
    sk = tt.keygen_reference(tt.PARAMS_110)
    with open(GOLDEN) as f:
        golden = json.load(f)
    ga, gb = ref_keygen.encrypt_bits(sk.lwe_key, golden["x_bits"] + golden["y_bits"])
    sk.cloud = sk.cloud.to("cuda")
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
    circuit_launches = phase_circuits(sk, dev["smi"])
    phase_circuits_plain()

    kernels = [
        {"name": "blind_rotate", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:533",
         "launches": launches["blind_rotate_fused"], **timed["blind_rotate"]},
        {"name": "blind_rotate_ks", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:485",
         "launches": launches["blind_rotate_ks_fused"], **timed["blind_rotate_ks"]},
        {"name": "blind_rotate_fused_packed", "route": "cuda", "source": SOURCE_SMALL,
         "replaces": "tfhe_tpu/ops/cmux_pallas_packed.py:259",
         "launches": circuit_launches["blind_rotate_fused_packed"],
         **timed["blind_rotate_fused_packed"]},
    ]
    off_path = [{"name": "cmux_delta", "route": "cuda", "source": SOURCE,
                 "replaces": "tfhe_tpu/ops/cmux_pallas.py:575", **timed["cmux_delta"]}]
    log(json.dumps({"kernels": kernels, "off_path": off_path}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
