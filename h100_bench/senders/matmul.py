"""``matmul``: one encrypted matrix product a request (``linalg.matmul``) of
`rows` x `inner` by `inner` x `cols` matrices of `nbits`-bit numbers, from
`pool` pairs in turn."""
from __future__ import annotations

import time

import torch

import keys as K
import reference as ref
from sender import ciphertext, rng, sync, tensors


class Sender:
    block = 1

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.R, self.Kd, self.C = t["rows"], t["inner"], t["cols"]
        self.nbits, self.pool_n = t["nbits"], t["pool"]

    def setup(self):
        c, t = self.ctx, self.ctx.traffic
        draw = rng(c.seed, "matrices")
        g = K.generator(c.seed, c.device, "matrices")
        lo, hi = t["range"]
        self.pairs = []
        for _ in range(self.pool_n):
            a = draw.integers(lo, hi + 1, size=(self.R, self.Kd))
            b = draw.integers(lo, hi + 1, size=(self.Kd, self.C))
            cta = ciphertext(*K.encrypt_bits(c.keys, torch.as_tensor(
                ref.int_bits(a, self.nbits), device=c.device), g))
            ctb = ciphertext(*K.encrypt_bits(c.keys, torch.as_tensor(
                ref.int_bits(b, self.nbits), device=c.device), g))
            self.pairs.append((a, b, cta, ctb))
        self.results = []

    def call(self, j: int):
        from tfhe_tpu_torch import linalg
        _, _, cta, ctb = self.pairs[j]
        return linalg.matmul(cta, ctb, self.ctx.cloud)

    def warm(self):
        t0 = time.perf_counter()
        out = self.call(0)
        sync(self.ctx.device)
        return tensors(out), time.perf_counter() - t0

    def step(self, i: int):
        j = i % self.pool_n
        with torch.profiler.record_function("bench.matmul"):
            out = self.call(j)
        self.results.append((j, out))
        return 1, "matmul"

    def check(self, rank_digests=None) -> tuple:
        keys, t = self.ctx.keys, self.ctx.traffic
        wrong, failed, margin = 0, 0, 0.0
        for j, out in self.results:
            a, b, _, _ = self.pairs[j]
            bits, m = K.decrypt_bits(keys, out.a, out.b)
            got = ref.bits_int(bits.cpu().numpy())
            bad = int((got != ref.matmul(a, b, self.nbits)).sum())
            wrong += bad
            failed += bad > 0
            margin = max(margin, float(m.max()))
        checks = [
            {"name": "wrong_answers", "value": wrong, "limit": t["limits"]["wrong_answers"]},
            {"name": "margin_max", "value": margin, "limit": t["limits"]["margin_max"]},
        ]
        return checks, failed, {"elements": len(self.results) * self.R * self.C}
