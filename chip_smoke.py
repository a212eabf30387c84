#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits nonzero):
  1. device   the card's name, and its name and power limit from nvidia-smi;
  2. build    nvcc builds csrc/*.cu into build/tfhe_tpu_torch/ (seconds);
  3. kernels  every kernel against its plain-torch version on the card,
              byte-equal (tolerance: exact), and the time of each at the
              PARAMS_110 batch-256 shapes beside its plain version's;
  4. main     the reference's keys at PARAMS_110 on the card; a batch of 256
              encrypted AND gates through the fused route must decrypt to
              a & b, through the kernels (launch counters), equal the split
              route, and match the golden SHA-256 that tfhe_tpu computed on
              the CPU for 8 reference-encrypted inputs;
  5. timing   AND chained 5 times on the batch of 256, kernel route and plain
              route, in ms per batch and bootstraps/s.

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
BATCH = 256
CHAIN = 5
SOURCE = "tfhe_tpu_torch/csrc/cmux.cu"


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


def random_bk(params, n: int, rng: np.random.RandomState, device):
    """Random NTT-domain key slices in the bk_rows layout, with Shoup twins."""
    from tfhe_tpu_torch import ntt
    from tfhe_tpu_torch.core.keys import bk_rows_layout
    bk = np.stack([rng.randint(0, p, size=(n, params.kpl, params.k + 1, params.N))
                   .astype(np.uint32) for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    return (torch.from_numpy(bk_rows_layout(bk)).to(device),
            torch.from_numpy(bk_rows_layout(sh)).to(device))


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
    return rows


def phase_kernels(sk, x) -> dict:
    """K1, K3 and K4 at the PARAMS_110 batch-256 shapes: byte-equal to the
    plain versions on real keys and a real accumulator, and timed."""
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
    return out


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

    timed = phase_kernels(sk, x)
    launches = phase_main(sk, golden_in, x, y, bits_x, bits_y)
    phase_timing(sk, x, y, bits_x & bits_y, dev["smi"])

    kernels = [
        {"name": "blind_rotate", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:533",
         "launches": launches["blind_rotate_fused"], **timed["blind_rotate"]},
        {"name": "blind_rotate_ks", "route": "cuda", "source": SOURCE,
         "replaces": "tfhe_tpu/ops/cmux_pallas.py:485",
         "launches": launches["blind_rotate_ks_fused"], **timed["blind_rotate_ks"]},
    ]
    off_path = [{"name": "cmux_delta", "route": "cuda", "source": SOURCE,
                 "replaces": "tfhe_tpu/ops/cmux_pallas.py:575", **timed["cmux_delta"]}]
    log(json.dumps({"kernels": kernels, "off_path": off_path}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
