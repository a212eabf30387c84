"""``gate_chain``: a circuit of `batch` independent two-input gates evaluated
level by level. Each request is one gate call on the whole batch, its kind
drawn from `gates`, x the previous level's output and y the next of `pool`
batches encrypted in set-up. On a mesh (a cell of several chips) the call is
the sharded gate. The client keeps `depth` levels in flight."""
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
        self.batch, self.pool_n, self.kinds = t["batch"], t["pool"], list(t["gates"])
        self.draw = rng(ctx.seed, "gates")

    def next_kind(self) -> str:
        return self.kinds[int(self.draw.integers(len(self.kinds)))]

    def setup(self):
        c = self.ctx
        g = K.generator(c.seed, c.device, "inputs")
        self.bits0 = torch.randint(0, 2, (self.batch,), generator=g, device=c.device)
        self.pool_bits = torch.randint(0, 2, (self.pool_n, self.batch), generator=g,
                                       device=c.device)
        self.x0 = ciphertext(*K.encrypt_bits(c.keys, self.bits0, g))
        self.pool = ciphertext(*K.encrypt_bits(c.keys, self.pool_bits, g))
        self.x, self.outs, self.steps = self.x0, [], []

    def gate(self, kind, x, y):
        c = self.ctx
        if c.mesh is None:
            from tfhe_tpu_torch import gates
            return gates.gate2(kind, x, y, c.cloud)
        from tfhe_tpu_torch.parallel import mesh
        return mesh.sharded_gate2(kind, x, y, c.cloud, c.mesh)

    def warm(self):
        for kind in self.kinds:
            self.gate(kind, self.x0, self.pool[0])
        sync(self.ctx.device)
        t0 = time.perf_counter()
        for kind in self.kinds:
            out = self.gate(kind, self.x0, self.pool[0])
        sync(self.ctx.device)
        return tensors(out), (time.perf_counter() - t0) / len(self.kinds)

    def step(self, i: int):
        kind = self.next_kind()
        with torch.profiler.record_function(f"bench.gate.{kind}"):
            out = self.gate(kind, self.x, self.pool[i % self.pool_n])
        self.outs.append(out)
        self.steps.append(kind)
        self.x = out
        return self.batch, kind

    def digests(self) -> list:
        """One number a step's output, equal on two ranks only where their
        outputs are equal word for word."""
        n = self.ctx.keys.params.n
        w = torch.arange(1, n + 1, dtype=torch.int64, device=self.ctx.device)
        return [int(((o.a.to(torch.int64) * w).sum() * 3 + o.b.to(torch.int64).sum()).item())
                for o in self.outs]

    def check(self, rank_digests=None) -> tuple:
        c, t = self.ctx, self.ctx.traffic
        keys = c.keys
        want = self.bits0.to(torch.int64)
        wrong_steps = set()
        wrong_bits, margin = 0, 0.0
        for i, (kind, out) in enumerate(zip(self.steps, self.outs)):
            want = ref.TRUTH[kind](want, self.pool_bits[i % self.pool_n].to(torch.int64))
            bits, m = K.decrypt_bits(keys, out.a, out.b)
            bad = int((bits.to(torch.int64) != want).sum())
            wrong_bits += bad
            margin = max(margin, float(m.max()))
            if bad:
                wrong_steps.add(i)
        # word-for-word: the reference recomputes sampled rows of sampled
        # steps from the inputs of the step (the first step's are the
        # benchmark's encryptions; a later one's, the output of the step
        # before it, which the decryption above judged)
        steps = len(self.outs)
        pick = rng(c.seed, "check")
        picks = sorted({0, steps - 1} | set(pick.integers(0, steps, size=t["check_steps"]).tolist()))
        ra, rb, rows_of = [], [], []
        for i in picks:
            rows = torch.as_tensor(pick.choice(self.batch, size=min(t["check_rows"], self.batch),
                                               replace=False), device=c.device)
            x = self.x0 if i == 0 else self.outs[i - 1]
            y = self.pool[i % self.pool_n]
            a, b = ref.affine(self.steps[i], x.a[rows], x.b[rows], y.a[rows], y.b[rows])
            ra.append(a)
            rb.append(b)
            rows_of.append((i, rows))
        got_a, got_b = ref.bootstrap(keys, torch.cat(ra), torch.cat(rb))
        mismatch, s = 0, 0
        for i, rows in rows_of:
            r = rows.shape[0]
            out = self.outs[i]
            bad = int((got_a[s:s + r] != out.a[rows]).sum() + (got_b[s:s + r] != out.b[rows]).sum())
            mismatch += bad
            if bad:
                wrong_steps.add(i)
            s += r
        checks = [
            {"name": "wrong_bits", "value": wrong_bits, "limit": t["limits"]["wrong_bits"]},
            {"name": "mismatch_words", "value": mismatch, "limit": t["limits"]["mismatch_words"]},
        ]
        if rank_digests is not None:
            mine = rank_digests[0]
            differ = sum(any(d[i] != mine[i] for d in rank_digests[1:]) for i in range(steps))
            checks.append({"name": "rank_mismatch_steps", "value": differ,
                           "limit": t["limits"]["rank_mismatch_steps"]})
            wrong_steps |= {i for i in range(steps)
                            if any(d[i] != mine[i] for d in rank_digests[1:])}
        info = {"rows_compared": sum(r.shape[0] for _, r in rows_of),
                "steps_compared": len(picks), "bits_decrypted": steps * self.batch,
                "margin_max": margin}
        return checks, len(wrong_steps), info
