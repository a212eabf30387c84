"""Evaluator ("cloud"), as cpuParallel/cloud.cpp.

Loads `cloud.key` and `cloud.data` (no secret key), evaluates the requested
encrypted circuit, and writes `answer.data`.

Usage: python -m tfhe_tpu_torch.apps.cloud [--op add|mul|min|gt|...] [--bits 16]
                                           [--dir .] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from tfhe_tpu_torch import arith, io as tio
from tfhe_tpu_torch.apps import add_device_argument, device_of
from tfhe_tpu_torch.utils.profiling import PhaseTimer

OPS = {
    "add": arith.add,
    "add_numberwise": arith.add_numberwise,
    "sub": arith.sub,
    "mul": arith.mul,
    "karatsuba": arith.mul_karatsuba,
    "div": arith.div,
    "min": arith.minimum,
    "gt": arith.gt,
    "eq": arith.eq,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="add", choices=list(OPS))
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args)
    with open(os.path.join(args.dir, "cloud.key"), "rb") as f:
        params, cloud = tio.import_cloud_keyset(f, device)
    with open(os.path.join(args.dir, "cloud.data"), "rb") as f:
        ca = tio.import_ciphertexts(f, args.bits, params.n, device)
        cb = tio.import_ciphertexts(f, args.bits, params.n, device)

    timer = PhaseTimer(device)
    with timer.phase(args.op):                  # synchronised at its end
        out = OPS[args.op](ca, cb, cloud)
    print(f"{args.op}: {timer.totals[args.op]:.3f} s")

    with open(os.path.join(args.dir, "answer.data"), "wb") as f:
        tio.export_ciphertexts(f, out)
    print("wrote answer.data")


if __name__ == "__main__":
    main()
