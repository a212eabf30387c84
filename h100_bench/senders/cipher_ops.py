"""``cipher_ops``: one `nbits`-bit CipherInt operation a request, the
operations of `ops` in blocks of one each, each block in an order drawn from
the seed (every seed sends the same work); operands from a pool of `pool`
pairs a kind, drawn over `ranges`."""
from __future__ import annotations

import time

import numpy as np
import torch

import keys as K
import reference as ref
from sender import ciphertext, rng, sync, tensors

OPS = {
    "add": lambda A, B: (A + B).ct, "sub": lambda A, B: (A - B).ct,
    "mul": lambda A, B: (A * B).ct, "gt": lambda A, B: A > B, "eq": lambda A, B: A.eq(B),
    "abs": lambda A, B: A.abs().ct, "min": lambda A, B: A.minimum(B).ct,
    "div": lambda A, B: (A / B).ct,
}


class Sender:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.ops, self.nbits, self.pool_n = list(t["ops"]), t["nbits"], t["pool"]
        self.block = len(self.ops)
        self.draw = rng(ctx.seed, "ops")
        self.pending = []

    def next_op(self) -> str:
        if not self.pending:
            self.pending = self.draw.permutation(len(self.ops)).tolist()
        return self.ops[self.pending.pop(0)]

    def setup(self):
        c, t = self.ctx, self.ctx.traffic
        draw = rng(c.seed, "operands")
        g = K.generator(c.seed, c.device, "operands")
        self.values, self.cts = {}, {}
        for op in self.ops:
            lo, hi = t["ranges"][op]
            a = draw.integers(lo, hi + 1, size=self.pool_n)
            b = draw.integers(lo, hi + 1, size=self.pool_n)
            if op == "div":
                b = np.where(b == 0, 1, b)
            self.values[op] = (a, b)
            bits = torch.as_tensor(ref.int_bits(np.stack([a, b]), self.nbits), device=c.device)
            self.cts[op] = ciphertext(*K.encrypt_bits(c.keys, bits, g))   # [2, pool, nbits]
        self.used = {op: 0 for op in self.ops}
        self.results = []

    def call(self, op: str, j: int):
        from tfhe_tpu_torch import CipherInt
        ct, cloud = self.cts[op], self.ctx.cloud
        return OPS[op](CipherInt(ct[0, j], cloud), CipherInt(ct[1, j], cloud))

    def warm(self):
        from tfhe_tpu_torch import arith
        took, widest = 0.0, None
        for op in self.ops:
            for j in range(arith.CAPTURE_AFTER + 1):     # eager calls, the capture, a replay
                t0 = time.perf_counter()
                out = self.call(op, j % self.pool_n)
                sync(self.ctx.device)
            took += time.perf_counter() - t0
            if widest is None or out.b.numel() > widest.b.numel():
                widest = out
        return tensors(widest), took / len(self.ops)

    def step(self, i: int):
        op = self.next_op()
        j = self.used[op] % self.pool_n
        self.used[op] += 1
        with torch.profiler.record_function(f"bench.op.{op}"):
            out = self.call(op, j)
        self.results.append((op, j, out))
        return 1, op

    def check(self, rank_digests=None) -> tuple:
        keys, t = self.ctx.keys, self.ctx.traffic
        wrong, margin, bits_seen = 0, 0.0, 0
        for op, j, out in self.results:
            bits, m = K.decrypt_bits(keys, out.a, out.b)
            bits = bits.cpu().numpy().reshape(-1)
            got = int(bits[0]) if op in ("gt", "eq") else int(ref.bits_int(bits))
            a, b = (int(v[j]) for v in self.values[op])
            wrong += got != ref.cipher_op(op, a, b, self.nbits)
            margin = max(margin, float(m.max()))
            bits_seen += bits.size
        checks = [
            {"name": "wrong_answers", "value": wrong, "limit": t["limits"]["wrong_answers"]},
            {"name": "margin_max", "value": margin, "limit": t["limits"]["margin_max"]},
        ]
        return checks, wrong, {"answers": len(self.results), "bits_decrypted": bits_seen}
