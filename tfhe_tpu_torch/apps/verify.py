"""Decryptor, as the reference's verify step (cpuParallel/verif.cpp-style).

Loads `secret.key` and `answer.data`, decrypts, prints the integer.

Usage: python -m tfhe_tpu_torch.apps.verify [--bits 16] [--dir .] [--unsigned]
                                            [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from tfhe_tpu_torch import io as tio
from tfhe_tpu_torch.apps import add_device_argument, device_of
from tfhe_tpu_torch.core.crypt import decrypt_bits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--unsigned", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args)
    with open(os.path.join(args.dir, "secret.key"), "rb") as f:
        sk = tio.import_secret_keyset(f, device)
    with open(os.path.join(args.dir, "answer.data"), "rb") as f:
        ct = tio.import_ciphertexts(f, args.bits, sk.params.n, device)

    bits = decrypt_bits(sk, ct).astype(np.int64)
    val = int(np.sum(bits * (1 << np.arange(args.bits))))
    if not args.unsigned and bits[-1]:
        val -= 1 << args.bits
    print(val)
    return val


if __name__ == "__main__":
    main()
