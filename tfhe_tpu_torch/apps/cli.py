"""Experiment suite CLI, with the reference GPU app's argv interface
(`gpuParallel/main.cu:2714-2798`: ./main <bitSize> <a> <b> <vLength>) and its
experiment suite (gates / compound / addition / multiplication / vector /
matrix), each step verified by decryption (testCipher, main.cu:491-507).

Usage:
  python -m tfhe_tpu_torch.apps.cli <bitSize> <a> <b> <vLength>
      [--params 110|toy|small] [--experiments ...] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, gates, linalg
from tfhe_tpu_torch.apps import add_device_argument, device_of
from tfhe_tpu_torch.utils.profiling import PhaseTimer


def _check(name, got, want):
    ok = np.array_equal(np.asarray(got), np.asarray(want))
    print(f"  {name:28s} -> {got} (expected {want}) {'OK' if ok else 'FAIL'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bitSize", type=int)
    ap.add_argument("a", type=int)
    ap.add_argument("b", type=int)
    ap.add_argument("vLength", type=int, nargs="?", default=4)
    ap.add_argument("--params", choices=["110", "toy", "small"], default="110")
    ap.add_argument("--experiments", nargs="*",
                    default=["gates", "add", "mul", "vector", "matrix"])
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args)
    params = {"110": tt.PARAMS_110, "toy": tt.PARAMS_TOY, "small": tt.PARAMS_SMALL}[args.params]
    nb, L = args.bitSize, args.vLength
    mask = (1 << nb) - 1
    timer = PhaseTimer(device)

    def signed(v):
        v &= mask
        return v - (1 << nb) if v & (1 << (nb - 1)) else v

    def run(name, fn, *operands):
        """fn(*operands, cloud) as a timed phase: (result, seconds)."""
        with timer.phase(name):
            out = fn(*operands, sk.cloud)
        return out, timer.totals[name]

    def encrypt(value, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return arith.encrypt_int(sk, value, nb, gen, device)

    print(f"keygen (seed 314/1592/657, params={args.params}, device={device})...")
    with timer.phase("keygen"):
        sk = tt.keygen(params, seed=(314, 1592, 657), device=device)
    print(f"  {timer.totals['keygen']:.1f} s")

    ca, cb = encrypt(args.a, 1), encrypt(args.b, 2)
    ok = True

    if "gates" in args.experiments:
        print("== gate + compound gate (test_AND_XOR_CompoundGate_Addition, main.cu:893) ==")
        (g_and, g_xor), dt = run(
            "AND||XOR", lambda x, y, cloud: gates.gate2_pair("AND", "XOR", x, y, x, y, cloud),
            ca, cb)
        print(f"  {nb}-bit AND||XOR compound batch: {dt:.3f} s")
        ok &= _check("AND", arith.decrypt_int(sk, g_and, signed=False),
                     (args.a & args.b) & mask)
        ok &= _check("XOR", arith.decrypt_int(sk, g_xor, signed=False),
                     (args.a ^ args.b) & mask)

    if "add" in args.experiments:
        print("== addition (GPU_1 bitwise + GPU_n numberwise) ==")
        for name, fn in (("add(GPU_1)", arith.add), ("add(GPU_n)", arith.add_numberwise)):
            s, dt = run(name, fn, ca, cb)
            ok &= _check(f"{name} [{dt:.2f}s]", arith.decrypt_int(sk, s), signed(args.a + args.b))

    if "mul" in args.experiments:
        print("== multiplication (naive + karatsuba) ==")
        for name, fn in (("mul(naive)", arith.mul), ("mul(karatsuba)", arith.mul_karatsuba)):
            m, dt = run(name, fn, ca, cb)
            ok &= _check(f"{name} [{dt:.2f}s]", arith.decrypt_int(sk, m), signed(args.a * args.b))

    if "vector" in args.experiments:
        print(f"== vector ops (length {L}) ==")
        rng = np.random.RandomState(7)
        va = rng.randint(0, 1 << (nb - 2), size=L)
        vb = rng.randint(0, 1 << (nb - 2), size=L)
        cva, cvb = encrypt(va, 3), encrypt(vb, 4)
        vs, dt = run("vector add", linalg.vector_add, cva, cvb)
        ok &= _check(f"vector add [{dt:.2f}s]", arith.decrypt_int(sk, vs),
                     [signed(int(x + y)) for x, y in zip(va, vb)])
        vm, dt = run("vector mul", linalg.vector_mul, cva, cvb)
        ok &= _check(f"vector mul [{dt:.2f}s]", arith.decrypt_int(sk, vm),
                     [signed(int(x * y)) for x, y in zip(va, vb)])

    if "matrix" in args.experiments:
        d = max(2, int(L ** 0.5))
        print(f"== {d}x{d} matrix multiply (flattened tree + Cannon) ==")
        rng = np.random.RandomState(8)
        ma = rng.randint(0, 4, size=(d, d))
        mb = rng.randint(0, 4, size=(d, d))
        cma, cmb = encrypt(ma, 5), encrypt(mb, 6)
        want = np.vectorize(signed)(ma @ mb)
        mm, dt = run("matmul", linalg.matmul, cma, cmb)
        ok &= _check(f"matmul [{dt:.2f}s]", arith.decrypt_int(sk, mm).tolist(), want.tolist())
        mc, dt = run("cannon", linalg.cannon_matmul, cma, cmb)
        ok &= _check(f"cannon [{dt:.2f}s]", arith.decrypt_int(sk, mc).tolist(), want.tolist())

    print("== time by phase ==")
    print(timer.report())
    print("ALL OK" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
