"""The one-block-per-S-samples blind rotate (K2/K3/K4) and external product
(K1) of tfhe_tpu_torch/csrc: what a block reads, where it writes and in
which order it works, held on the CPU against the port's plain code and
against tfhe_tpu.

The CUDA sources cannot run here, and nothing in this file runs them: the
check of the kernels is tests/test_torch_cuda.py and chip_smoke.py, on the
card, against the plain versions. The models below follow the kernels' own
loops (csrc/extern_product.cuh, csrc/cmux.cu) task for task, with numpy arrays
standing for the threads of a phase: the block's samples and the ragged last
block, the three task decodings, the padded rows and the bank shifts between
rows and samples, the rows the inverse reuses, the 16-byte chunks of the key
slice in the bk_rows layout, the sums exchanged between neighbouring lanes,
the key buffers and their barriers' parities, the primes in sequence and the
CRT in registers. They check index
arithmetic only, not the CUDA code. Tolerance: exact (integers).

The same seeded numpy inputs go through the model, ``core.bootstrap`` (the
plain version) and ``tfhe_tpu.ops.cmux_pallas`` in interpret mode, as
tfhe_tpu's own tests run it on the CPU.
"""
import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import cmux_pallas as jcp
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, gates, ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.ops import cmux
from tfhe_tpu_torch.params import TfheParams

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

M32 = np.uint64(0xFFFFFFFF)
KPL, KOUT = 4, 2


def _params(N, n):
    return TfheParams(n=n, N=N, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
                      ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0)


def _case(N, n, B, seed):
    params = _params(N, n)
    rng = np.random.RandomState(seed)
    bk = np.stack([rng.randint(0, p, size=(n, KPL, KOUT, N)).astype(np.uint32)
                   for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(B, KOUT, N)).astype(np.int32)
    bara = rng.randint(0, 2 * N, size=(B, n)).astype(np.int32)
    bara[0, 0] = 0                                     # a step that rotates by nothing
    dec = rng.randint(-params.halfBg, params.halfBg, size=(B, KPL, N)).astype(np.int32)
    return params, bk, sh, keys.bk_rows_layout(bk), keys.bk_rows_layout(sh), acc, bara, dec


# ------------------------------------------------ the arithmetic of a thread

def _pad(e):
    """row_pad of extern_product.cuh."""
    return e + ((e >> 5) << 2)


def _lazy_mul(x, w, w_sh, p):
    """lazy_mul of ntt_passes.cuh on uint64 arrays holding 32-bit values."""
    assert (x <= M32).all()
    r = (x * w - ((x * w_sh) >> np.uint64(32)) * np.uint64(p)) & M32
    assert (r < 2 * p).all()
    return r


def _fold(x, m):
    assert (x < 2 * m).all()
    return np.minimum(x, (x - np.uint64(m)) & M32)


def _butterfly(v, j, half, w, w_sh, p):
    x = _fold(v[:, j], 2 * p)
    wv = _lazy_mul(v[:, j + half], w, w_sh, p)
    v[:, j], v[:, j + half] = x + wv, x + np.uint64(2 * p) - wv
    assert (v[:, j] < 4 * p).all() and (v[:, j + half] < 4 * p).all()


def _fwd_pass(v, s0, hi, tw, p):
    """fwd_pass: v uint64[tasks, 8], hi int[tasks]; tw = (psi_br, its twin)."""
    for a in range(3):
        half = 4 >> a
        for j in range(8):
            if not j & half:
                i = (1 << (s0 + a)) + (hi << a) + (j >> (3 - a))
                _butterfly(v, j, half, tw[0][i], tw[1][i], p)


def _fwd_tail(v, tail, g, N, tw, p):
    for a in range(2 - tail, 2):
        half = 2 >> a
        for j in range(4):
            if not j & half:
                i = (N >> (2 - a)) + (g << a) + (j >> (2 - a))
                _butterfly(v, j, half, tw[0][i], tw[1][i], p)


def _inv_pass(v, lt0, a_first, hi, N, logN, tw, tabs, p):
    for a in range(a_first, 2):
        half, lt = 1 << a, lt0 + a
        for j in range(4):
            if j & half:
                continue
            x, y = v[:, j].copy(), v[:, j + half].copy()
            assert (x < 2 * p).all() and (y < 2 * p).all()
            if lt == logN - 1:
                v[:, j] = _fold(_lazy_mul(x + y, np.uint64(tabs["n_inv"]),
                                          np.uint64(tabs["n_inv_shoup"]), p), p)
                v[:, j + half] = _fold(_lazy_mul(x + np.uint64(2 * p) - y,
                                                 np.uint64(tabs["ipsi1_ninv"]),
                                                 np.uint64(tabs["ipsi1_ninv_shoup"]), p), p)
            else:
                i = (N >> (lt + 1)) + hi * (2 >> a) + (j >> (a + 1))
                v[:, j] = _fold(x + y, 2 * p)
                v[:, j + half] = _lazy_mul(x + np.uint64(2 * p) - y, tw[0][i], tw[1][i], p)


def _crt(r1, r2):
    """crt of extern_product.cuh on uint64 arrays of residues in [0, p)."""
    P1, P2 = ntt.PRIMES
    r1p2 = np.where(r1 >= P2, r1 - np.uint64(P2), r1)
    d = np.where(r2 >= r1p2, r2 - r1p2, r2 + np.uint64(P2) - r1p2)
    t = _lazy_mul(d, np.uint64(ntt._INV_P1_MOD_P2), np.uint64(ntt._INV_P1_SHOUP), P2)
    t = np.where(t >= P2, t - np.uint64(P2), t)
    rep = (r1 + np.uint64(P1) * t) & M32
    upper = (t > ntt._T_HALF) | ((t == ntt._T_HALF) & (r1 >= ntt._R1_HALF))
    return np.where(upper, (rep - np.uint64(ntt._M_MOD_2_32)) & M32, rep)


# ------------------------------------------------------- the model of a block

class Block:
    """One block of the form (S, nbuf) at N: its shared memory as numpy arrays
    and the external product as extern_product.cuh runs it. `key` and `key_sh`
    are the whole key in the bk_rows layout, flat, as the kernel addresses it."""

    def __init__(self, N, S, nbuf, key, key_sh):
        self.N, self.S, self.nbuf = N, S, nbuf
        self.logN = N.bit_length() - 1
        self.RS = N + (N >> 3) + 2
        self.SS = KPL * self.RS + 1
        self.tasks = np.arange(S * N // 2)
        self.rows = np.zeros(S * self.SS, np.uint64)
        self.slice = 8 * N
        self.key, self.key_sh = key.reshape(-1).astype(np.uint64), key_sh.reshape(-1).astype(np.uint64)
        self.keybuf = np.zeros((max(nbuf, 1), 2, self.slice), np.uint64)
        self.holds = [None] * nbuf            # which use each buffer holds
        self.phases = [0] * nbuf              # completed phases of each barrier
        self.tabs = [ntt.ntt_tables(N, p) for p in ntt.PRIMES]
        assert 4 * (self.keybuf.size * (nbuf > 0) + 8 * N + 4 + 16 + S * KOUT * N
                    + self.rows.size) == cmux.cmux_smem_bytes(N, S, nbuf, 2)

    def fetch(self, u, uses):
        """cmux_fetch_key: one bulk copy each of the slice's values and twins."""
        if self.nbuf > 0 and u < uses:
            buf = u % self.nbuf
            self.keybuf[buf, 0] = self.key[u * self.slice:(u + 1) * self.slice]
            self.keybuf[buf, 1] = self.key_sh[u * self.slice:(u + 1) * self.slice]
            self.holds[buf] = u
            self.phases[buf] += 1

    def chunk(self, use, at):
        """The 16-byte chunks at word offsets `at` of the slice of `use`:
        (values uint64[tasks, 4], twins)."""
        idx = at[:, None] + np.arange(4)
        if self.nbuf > 0:
            buf = use % self.nbuf
            # mbar_wait(parity (use / nbuf) & 1) returns once that phase is over
            assert self.phases[buf] == use // self.nbuf + 1 and self.holds[buf] == use
            return self.keybuf[buf, 0][idx], self.keybuf[buf, 1][idx]
        return self.key[use * self.slice + idx], self.key_sh[use * self.slice + idx]

    def extern_product(self, digits, step, steps):
        """delta uint64[tasks, 4]: task t is polynomial (t / (N/4)) % 2 of sample
        t / (N/2), coefficient t % (N/4) + j*N/4. digits(s, row, q, p) ->
        uint64[tasks, 8] residues."""
        N, S, logN, RS, SS, t = self.N, self.S, self.logN, self.RS, self.SS, self.tasks
        tail = logN % 3
        res = []
        for pi, p in enumerate(ntt.PRIMES):
            use = 2 * step + pi
            tabs = self.tabs[pi]
            twf = (tabs["psi_br"].astype(np.uint64), tabs["psi_br_shoup"].astype(np.uint64))
            twi = (tabs["ipsi_br"].astype(np.uint64), tabs["ipsi_br_shoup"].astype(np.uint64))
            # forward passes
            q, row, s = t % (N // 8), (t // (N // 8)) % KPL, t // (N // 2)
            for s0 in range(0, logN - tail, 3):
                lu = logN - s0 - 3
                hi = q >> lu
                x = s * SS + row * RS + _pad((hi << (lu + 3)) + (q & ((1 << lu) - 1)))
                at = x[:, None] + _pad(np.arange(8) << lu)
                v = digits(s, row, q, p) if s0 == 0 else self.rows[at]
                _fwd_pass(v, s0, hi, twf, p)
                assert len(set(at.reshape(-1).tolist())) == at.size      # no two tasks share a word
                self.rows[at] = v
            # the product: a thread takes rows 2*half, 2*half + 1 against both
            # polynomials' key columns and finishes polynomial `half`
            s, half, iq = t % S, (t // S) % 2, t // (S * 2)
            xs = s * SS + _pad(4 * iq)
            x = [self.rows[(xs + (2 * half + rr) * RS)[:, None] + np.arange(4)] for rr in range(2)]
            for rr in range(2):
                _fwd_tail(x[rr], tail, iq, N, twf, p)
            z = np.zeros((len(t), 4), np.uint64)
            for j in range(4):
                w, sw = self.chunk(use, (4 * iq + j) * 8 + 4 * half)
                c = [_fold(_lazy_mul(x[0][:, j], w[:, pol], sw[:, pol], p)
                           + _lazy_mul(x[1][:, j], w[:, 2 + pol], sw[:, 2 + pol], p), 2 * p)
                     for pol in range(KOUT)]
                mine = np.where(half == 1, c[1], c[0])
                send = np.where(half == 1, c[0], c[1])
                assert ((t ^ S) // 32 == t // 32).all()          # the neighbour is a lane of the warp
                z[:, j] = _fold(mine + send[t ^ S], 2 * p)       # __shfl_xor_sync(.., S)
            _inv_pass(z, 0, 0, iq, N, logN, twi, tabs, p)
            at = (xs + half * RS)[:, None] + np.arange(4)
            assert len(set(at.reshape(-1).tolist())) == at.size
            self.rows[at] = z
            self.fetch(use + self.nbuf, 2 * steps)
            # inverse passes
            iq, pol, s = t % (N // 4), (t // (N // 4)) % KOUT, t // (N // 2)
            for l0 in range(2, logN, 2):
                l0e = min(l0, logN - 2)
                hi = iq >> l0e
                base = (hi << (l0e + 2)) + (iq & ((1 << l0e) - 1))
                at = (s * SS + pol * RS + _pad(base))[:, None] + _pad(np.arange(4) << l0e)
                z = self.rows[at]
                _inv_pass(z, l0e, l0 - l0e, hi, N, logN, twi, tabs, p)
                if l0 + 2 < logN:
                    self.rows[at] = z
                else:
                    assert (base == iq).all()          # natural order: iq + j*N/4
                    res.append(z)
        return _crt(res[0], res[1])


def blind_rotate_model(acc, bara, key, key_sh, params, S, nbuf):
    """blind_rotate_kernel<LOGN, S, nbuf> over the grid: acc int32[B, 2, N]."""
    N, (B, n) = params.N, bara.shape
    out = acc.copy()
    for first in range(0, B, S):
        blk = Block(N, S, nbuf, key, key_sh)
        live = [first + s < B for s in range(S)]
        a = np.zeros((S, KOUT, N), np.uint64)              # a sample past the batch: zeros
        for s in range(S):
            if live[s]:
                a[s] = acc[first + s].astype(np.int64) % 2 ** 32
        blk.fetch(0, 2 * n)
        if nbuf > 1:
            blk.fetch(1, 2 * n)
        for step in range(n):
            rot = np.array([bara[first + s, step] if live[s] else 0 for s in range(S)])

            def digits(s, row, q, p):
                i = q[:, None] + np.arange(8) * (N // 8)
                d = (i - rot[s][:, None]) % (2 * N)
                neg = d >= N
                ac = a[s, row >> 1]                        # [tasks, N]
                rows = np.arange(len(s))[:, None]
                x = ac[rows, np.where(neg, d - N, d)]
                u = (np.where(neg, (0 - x) & M32, x) - ac[rows, i] + np.uint64(params.decomp_offset)) & M32
                sh = (32 - ((row & 1) + 1) * params.bk_Bgbit).astype(np.uint64)
                dg = (u >> sh[:, None]) & np.uint64(params.maskMod)
                half = np.uint64(params.halfBg)
                return dg + np.uint64(2 * p) - half            # digit - Bg/2, in (p, 3p)

            delta = blk.extern_product(digits, step, n)
            t = blk.tasks
            at = (t // (N // 4) * N + t % (N // 4))[:, None] + np.arange(4) * (N // 4)
            flat = a.reshape(-1)
            flat[at] = (flat[at] + delta) & M32
        for s in range(S):
            if live[s]:
                out[first + s] = a[s].astype(np.uint32).view(np.int32)
            else:
                assert not a[s].any()                      # zeros in, zeros out: nothing to store
    return out


def cmux_delta_model(dec, key, key_sh, params, S, nbuf):
    """cmux_delta_kernel<LOGN, S, nbuf>: dec int32[B, 4, N] -> int32[B, 2, N]."""
    N, B = params.N, dec.shape[0]
    out = np.zeros((B, KOUT, N), np.int32)
    for first in range(0, B, S):
        blk = Block(N, S, nbuf, key, key_sh)
        blk.fetch(0, 2)
        if nbuf > 1:
            blk.fetch(1, 2)

        def digits(s, row, q, p):
            i = q[:, None] + np.arange(8) * (N // 8)
            live = first + s < B
            d = dec[np.minimum(first + s, B - 1)[:, None], row[:, None], i].astype(np.int64)
            return (np.where(live[:, None], d, 0) + 2 * p).astype(np.uint64)

        delta = blk.extern_product(digits, 0, 1)
        t = blk.tasks
        for k in np.flatnonzero(first + t // (N // 2) < B):
            smp, pol, iq = first + t[k] // (N // 2), (t[k] // (N // 4)) % KOUT, t[k] % (N // 4)
            out[smp, pol, iq + np.arange(4) * (N // 4)] = delta[k].astype(np.uint32).view(np.int32)
    return out


FORMS = {1: 0, 2: 2, 4: 2}          # key buffers of the form with S samples a block


def _batches(S):
    return sorted({1, S - 1, S + 1} - {0})


# a block has N/2 threads a sample and at most 1024: no four samples at N = 1024
CASES = [(N, S, B) for N in (64, 256, 1024) for S in (1, 2, 4) for B in _batches(S)
         if S * N // 2 <= 1024]


@pytest.mark.parametrize("N,S,B", CASES)
def test_blind_rotate_model_matches_plain_and_pallas(N, S, B):
    """K3 (and, one step of it, K2): S samples a block sharing each key slice,
    a ragged last block, three steps so that every buffer's barrier flips."""
    n = 3 if N < 1024 else 2
    params, bk, sh, rows, rows_sh, acc, bara, _ = _case(N, n, B, seed=N + 10 * S + B)
    got = blind_rotate_model(acc, bara, rows, rows_sh, params, S, FORMS[S])
    want = bs.blind_rotate(torch.from_numpy(acc), torch.from_numpy(bara), torch.from_numpy(bk),
                           torch.from_numpy(sh), params).numpy()
    np.testing.assert_array_equal(got, want)
    acc_t, bara_t = acc.transpose(1, 2, 0), bara.T
    jax_out = np.asarray(jcp.blind_rotate_fused(jnp.asarray(acc_t), jnp.asarray(bara_t),
                                                jnp.asarray(rows), jnp.asarray(rows_sh), params,
                                                interpret=True))
    np.testing.assert_array_equal(got.transpose(1, 2, 0), jax_out)
    wrapped = cmux.blind_rotate_fused(torch.from_numpy(acc_t.copy()), torch.from_numpy(bara_t.copy()),
                                      torch.from_numpy(rows), torch.from_numpy(rows_sh), params)
    np.testing.assert_array_equal(wrapped.numpy(), jax_out)


@pytest.mark.parametrize("N,S,B", CASES)
def test_cmux_delta_model_matches_plain_and_pallas(N, S, B):
    """K1: one external product on S samples of given digits a block."""
    params, bk, sh, rows, rows_sh, _, _, dec = _case(N, 1, B, seed=N + 10 * S + B + 1)
    got = cmux_delta_model(dec, rows[0], rows_sh[0], params, S, FORMS[S])
    want = bs.extern_product_ntt(torch.from_numpy(dec), torch.from_numpy(bk[0]),
                                 torch.from_numpy(sh[0]), params).numpy()
    np.testing.assert_array_equal(got, want)
    dec_t = dec.transpose(1, 2, 0)
    jax_out = np.asarray(jcp.cmux_delta(jnp.asarray(dec_t), jnp.asarray(rows[0]),
                                        jnp.asarray(rows_sh[0]), params, interpret=True))
    np.testing.assert_array_equal(got.transpose(1, 2, 0), jax_out)
    wrapped = cmux.cmux_delta(torch.from_numpy(dec_t.copy()), torch.from_numpy(rows[0]),
                              torch.from_numpy(rows_sh[0]), params)
    np.testing.assert_array_equal(wrapped.numpy(), jax_out)


@pytest.mark.parametrize("S,nbuf", [(1, 0), (2, 1), (4, 2)])
def test_model_forms_agree_at_the_largest_ring(S, nbuf):
    """N = 2048 (two forward stages left to the product, the last inverse pass
    of one stage) in the form without key buffers, and a single and a double
    buffer at N = 128 (one stage left over), against the plain version."""
    N = 2048 if nbuf == 0 else 128
    params, bk, sh, rows, rows_sh, acc, bara, _ = _case(N, 2, S + 1, seed=S + nbuf)
    got = blind_rotate_model(acc, bara, rows, rows_sh, params, S, nbuf)
    want = bs.blind_rotate(torch.from_numpy(acc), torch.from_numpy(bara), torch.from_numpy(bk),
                           torch.from_numpy(sh), params).numpy()
    np.testing.assert_array_equal(got, want)


def test_a_late_key_copy_is_caught():
    """The model's barrier check has teeth: a block that never starts the copy
    for the second prime fails at the wait."""
    params, _, _, rows, rows_sh, acc, bara, _ = _case(64, 1, 1, seed=3)
    blk = Block(64, 2, 2, rows, rows_sh)
    blk.fetch(0, 2)
    with pytest.raises(AssertionError):
        blk.extern_product(lambda s, row, q, p: np.zeros((len(s), 8), np.uint64), 0, 1)


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048])
def test_plan_fits_and_covers_every_sample_once(N):
    for B in (1, 2, 3, 5, 255, 256, 257, 2049):
        S, nbuf = cmux.blind_rotate_plan(N, 2)
        assert (S, nbuf) in cmux.CMUX_FORMS[2]
        assert cmux.cmux_smem_bytes(N, S, nbuf, 2) <= cmux.SMEM_MAX
        threads = cmux.cmux_threads(N, S)
        assert threads <= 1024 and threads % 32 == 0
        blocks = -(-B // S)                              # the launch's grid
        held = [b * S + s for b in range(blocks) for s in range(S) if b * S + s < B]
        assert held == list(range(B))
        assert (blocks - 1) * S < B                      # no block without a sample


def test_smem_budget_at_params_110():
    """The forms at N = 1024 as the kernel lays them out: two samples with a
    double key buffer take 217,240 bytes of the 232,448 a block may use, and
    two blocks of one sample without buffers share an SM; at N = 2048 only
    the form without buffers fits."""
    assert cmux.cmux_smem_bytes(1024, 2, 2, 2) == 217240
    assert 2 * cmux.cmux_smem_bytes(1024, 1, 0, 2) <= cmux.SMEM_MAX
    assert cmux.blind_rotate_plan(1024, 2) == (2, 2)
    assert cmux.cmux_smem_bytes(2048, 2, 2, 2) > cmux.SMEM_MAX
    assert cmux.blind_rotate_plan(2048, 2)[1] == 0


# ----------------------------------------------------------------- the route

@pytest.mark.parametrize("fuseks", ["0", "1"])
def test_bootstrap_same_bytes_on_either_side_of_small_batch_max(monkeypatch, fuseks):
    """bootstrap() of 3 samples through the small-batch wrappers
    (small_batch_max = 3) and through the one-block-per-S-samples wrappers
    (small_batch_max = 2): the same bytes, and each route calls its wrappers."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=5, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    x = pt.encrypt_bits(sk, np.array([0, 1, 1]), gen, "cpu")
    called = []
    for name in ("blind_rotate_fused", "blind_rotate_ks_fused"):
        monkeypatch.setattr(cmux, name, lambda *a, _f=getattr(cmux, name), _n=name, **k:
                            (called.append(_n), _f(*a, **k))[1])
    outs, waves = [], bs.WAVES[2]
    for limit in (3, 2):
        monkeypatch.setitem(bs.WAVES, 2, dataclasses.replace(waves, small_batch_max=limit))
        called.clear()
        with config.overrides(TFHE_TPU_FUSEKS=fuseks):
            outs.append(bs.bootstrap(x, gates.MU, sk.cloud))
        want = [] if limit == 3 else ["blind_rotate_ks_fused" if fuseks == "1"
                                      else "blind_rotate_fused"]
        assert called == want
    assert torch.equal(outs[0].a, outs[1].a) and torch.equal(outs[0].b, outs[1].b)
    np.testing.assert_array_equal(pt.decrypt_bits(sk, outs[0]), [0, 1, 1])


@pytest.mark.parametrize("B,small", [
    (1, True), (30, True), (64, True), (132, True), (133, True), (192, True), (256, False),
    (264, False), (265, True), (396, True), (528, False), (660, True), (792, False),
    (858, True), (859, False), (1056, False), (1188, False),
    (2048, False), (4096, False)])
def test_route_follows_the_measured_sweep(B, small):
    """small_batch() picks, at every batch of the H100 sweep that core/bootstrap.py
    quotes, the kernel that was faster there (chip_smoke.py prints both times
    and the choice); it reads a batch and constants, no device."""
    assert bs.small_batch(B, pt.PARAMS_110) is small
    assert bs.WAVES[2].small_batch_max == 858
