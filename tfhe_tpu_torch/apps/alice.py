"""Key generator / encryptor ("Alice"), as cpuParallel/main.cpp:11-82.

Generates the secret and cloud keysets from the reference's fixed seed, writes
`secret.key` / `cloud.key`, encrypts the two argv integers bit by bit, and
writes them to `cloud.data`: the reference's client/cloud trust split.

Usage: python -m tfhe_tpu_torch.apps.alice <a> <b> [--bits 16] [--dir .]
                                           [--params 110|toy] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, io as tio
from tfhe_tpu_torch.apps import add_device_argument, device_of


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=int)
    ap.add_argument("b", type=int)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--params", choices=["110", "toy"], default="110")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args)
    params = tt.PARAMS_110 if args.params == "110" else tt.PARAMS_TOY
    # reference seed semantics (main.cu:2724-2726, cpuParallel/main.cpp:21-22)
    sk = tt.keygen(params, seed=(314, 1592, 657), device=device)

    os.makedirs(args.dir, exist_ok=True)
    with open(os.path.join(args.dir, "secret.key"), "wb") as f:
        tio.export_secret_keyset(f, sk)
    with open(os.path.join(args.dir, "cloud.key"), "wb") as f:
        tio.export_cloud_keyset(f, sk)

    def noise(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    ca = arith.encrypt_int(sk, args.a, args.bits, noise(1), device)
    cb = arith.encrypt_int(sk, args.b, args.bits, noise(2), device)
    with open(os.path.join(args.dir, "cloud.data"), "wb") as f:
        tio.export_ciphertexts(f, ca)
        tio.export_ciphertexts(f, cb)
    print(f"wrote secret.key, cloud.key, cloud.data ({args.bits}-bit a={args.a} b={args.b})")


if __name__ == "__main__":
    main()
