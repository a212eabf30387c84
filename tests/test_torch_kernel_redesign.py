"""What the redesigned key-switch and small-batch blind-rotate kernels read
and the order they work in, held on the CPU against the port's plain code.

The CUDA sources (tfhe_tpu_torch/csrc) cannot run here, and nothing in this
file runs them: the check of the kernels is tests/test_torch_cuda.py and
chip_smoke.py, on the card, against the plain versions, which the other
tests/test_torch_*.py files hold against tfhe_tpu. What these tests keep
honest is the index arithmetic the kernels were written from: numpy models
that follow the kernels' own loops, thread for thread, must give exactly what
``ntt.py`` and ``keyswitch_ref`` give; a change to a kernel's order of work
starts here, where there is no compiler. Tolerance: exact (integers).

- the plan that cuts a key switch into blocks (``cmux.keyswitch_plan``);
- the gather arm's partial sums and the tensor-core arm's fragments
  (``mma.m16n8k32`` register layout, the 4x4 byte transpose, the column and
  coefficient permutations) against ``keyswitch_ref``;
- the pass-wise transforms of ``ntt_passes.cuh`` as ``blind_rotate_small.cu``
  drives them (forward: 8 values a thread and three stages a pass, the stages
  left over with the MAC; inverse: 4 values and two stages; padded rows; lazy
  reduction) against ``ntt.ntt_forward_rows`` and ``ntt.ntt_inverse_rows``;
- the default device of ``keygen``.
"""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys, lwe
from tfhe_tpu_torch.ops import cmux
from tfhe_tpu_torch.params import TfheParams

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ----------------------------------------------------------------- the plan

@pytest.mark.parametrize("N", [64, 512, 1024])
@pytest.mark.parametrize("B", [1, 2, 3, 33, 132, 256])
def test_keyswitch_plan_covers_all_coefficients(N, B):
    """Each arm's ranges [i*N/split, (i+1)*N/split) tile [0, N) once, in the
    units its kernel works in."""
    for C in (128, 512):
        mma, split = cmux.keyswitch_plan(B, N, C)
        assert mma == (0 if B <= cmux.KS_GATHER_MAX else 1)
        assert split >= 1 and N % split == 0
        per = N // split
        covered = np.concatenate([np.arange(i * per, (i + 1) * per) for i in range(split)])
        np.testing.assert_array_equal(covered, np.arange(N))
        if mma:
            assert per % cmux.KS_MMA_STEP == 0
            tiles = (4 * C // cmux.KS_MMA_COLS) * -(-B // cmux.KS_MMA_ROWS)
            assert tiles * split <= max(cmux.KS_MMA_BLOCKS, tiles)
        else:
            assert per >= min(N, cmux.KS_GATHER_MIN_COEFFS)
            assert B * split <= max(cmux.KS_GATHER_BLOCKS, B)


# ------------------------------------------------- models of the key switch

def _ks_case(N, n, B, seed, kind="random"):
    params = TfheParams(n=n, N=N, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
                        ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0)
    rng = np.random.RandomState(seed)
    C = -(-(n + 1) // 128) * 128
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(2, N, B)).astype(np.int32)
    if kind == "zero_digits":      # u = x + prec_offset has no nonzero digit
        acc[0] = np.int32(params.ks_prec_offset)
        acc[0, 0] = -np.int32(params.ks_prec_offset)
    elif kind == "all_digits":     # every digit of every coefficient is 1, 2 or 3
        digs = rng.randint(1, 4, size=(N, B, 8))
        u = sum(digs[..., j].astype(np.int64) << (30 - 2 * j) for j in range(8)) + 1
        x = (u - params.ks_prec_offset).astype(np.int64)
        x[1:] = -x[1:]
        acc[0] = ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    tks = rng.randint(-128, 128, size=(24, N, 4 * C)).astype(np.int8)
    return params, acc, tks, C


def _u_of(acc, params):
    """uint32[B, N]: the offset extracted coefficients the kernels decompose."""
    a0 = acc[0].T.astype(np.int64)
    x = np.concatenate([a0[:, :1], -a0[:, 1:]], axis=1)
    return ((x + params.ks_prec_offset) % 2 ** 32).astype(np.uint32)


def _finish_model(sums, acc, u, params, C):
    """ks_finish_kernel: limb recombine, b_ext, count of nonzero digits."""
    s = sums.reshape(-1, 4, C).astype(np.uint32)
    r = (s[:, 0] + (s[:, 1] << 8) + (s[:, 2] << 16) + (s[:, 3] << 24)).astype(np.uint32)
    digs = np.stack([(u >> (30 - 2 * j)) & 3 for j in range(params.ks_t)], axis=-1)
    nnz = (digs != 0).sum(axis=(1, 2)).astype(np.int32)
    return r.view(np.int32), np.stack([acc[1, 0, :], nnz])


def _gather_model(acc, tks, params, C, split):
    """ks_gather_kernel: block (s, b) adds the rows of its coefficients; thread
    tid owns bytes 16*tid .. 16*tid+15 of a row."""
    N, B = params.N, acc.shape[2]
    u = _u_of(acc, params)
    per = N // split
    sums = np.zeros((B, 4 * C), np.int32)
    for b in range(B):
        for s in range(split):
            part = np.zeros(4 * C, np.int32)
            for m in range(s * per, (s + 1) * per):
                for jd in range(params.ks_t):
                    h = (int(u[b, m]) >> (32 - (jd + 1) * 2)) & 3
                    if h:
                        part += tks[jd * 3 + h - 1, m].astype(np.int32)
            sums[b] += part
    return _finish_model(sums, acc, u, params, C)


def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 scalars."""
    src = [(x >> (8 * i)) & 255 for i in range(4)] + [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _mma_m16n8k32(a_regs, b_regs):
    """mma.sync.m16n8k32 s8 x s8 -> s32 from the per-lane registers, by the
    PTX fragment layouts: A register a holds row g + 8*(a & 1), k = 16*(a >> 1)
    + 4*tig + byte; B register hf holds k = 16*hf + 4*tig + byte, column g;
    C register e holds row g + 8*(e >> 1), column 2*tig + (e & 1)."""
    A = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for a in range(4):
            for i in range(4):
                byte = (a_regs[lane][a] >> (8 * i)) & 255
                A[g + 8 * (a & 1), 16 * (a >> 1) + 4 * tig + i] = byte - 256 * (byte > 127)
        for hf in range(2):
            for i in range(4):
                byte = (b_regs[lane][hf] >> (8 * i)) & 255
                Bm[16 * hf + 4 * tig + i, g] = byte - 256 * (byte > 127)
    D = A @ Bm
    return [[D[(lane >> 2) + 8 * (e >> 1), 2 * (lane & 3) + (e & 1)] for e in range(4)]
            for lane in range(32)]


def _mma_model(acc, tks, params, C, split):
    """ks_mma_kernel for one warp's 16 samples at a time: the registers each
    lane builds and where it adds its accumulators."""
    N, B = params.N, acc.shape[2]
    u = _u_of(acc, params)
    per = N // split
    tks_w = np.ascontiguousarray(tks).view(np.uint32)          # [24, N, C] words of 4 columns
    sums = np.zeros((B, 4 * C), np.int64)
    for col0 in range(0, 4 * C, 128):
        for row0 in range(0, B, 16):
            for m0 in (m for z in range(split) for m in range(z * per, (z + 1) * per, 32)):
                for jh in range(24):                           # block z's steps, in its order
                    jd, h = jh // 3, jh % 3 + 1
                    sh = 32 - (jd + 1) * 2
                    a_regs = []
                    for lane in range(32):
                        g, tig = lane >> 2, lane & 3
                        regs = []
                        for a in range(4):
                            rr = row0 + g + 8 * (a & 1)
                            reg = 0
                            for i in range(4):
                                m = m0 + 16 * (a >> 1) + tig + 4 * i
                                dig = (int(u[rr, m]) >> sh) & 3 if rr < B else -1
                                reg |= int(dig == h) << (8 * i)
                            regs.append(reg)
                        a_regs.append(regs)
                    for G in range(4):
                        b_regs = [[[0, 0] for _ in range(32)] for _ in range(4)]   # [q][lane]
                        for lane in range(32):
                            g, tig = lane >> 2, lane & 3
                            for hf in range(2):
                                w = [int(tks_w[jh, m0 + 16 * hf + tig + 4 * i,
                                               (col0 + 32 * G) // 4 + g]) for i in range(4)]
                                t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
                                t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
                                b_regs[0][lane][hf] = _byte_perm(t0, t2, 0x5410)
                                b_regs[1][lane][hf] = _byte_perm(t0, t2, 0x7632)
                                b_regs[2][lane][hf] = _byte_perm(t1, t3, 0x5410)
                                b_regs[3][lane][hf] = _byte_perm(t1, t3, 0x7632)
                        for q in range(4):
                            c = _mma_m16n8k32(a_regs, b_regs[q])
                            for lane in range(32):
                                g, tig = lane >> 2, lane & 3
                                for e in range(4):
                                    rr = row0 + g + 8 * (e >> 1)
                                    cc = col0 + 32 * G + 4 * (2 * tig + (e & 1)) + q
                                    if rr < B:
                                        sums[rr, cc] += c[lane][e]
    return _finish_model(sums.astype(np.int32), acc, u, params, C)


@pytest.mark.parametrize("kind", ["random", "zero_digits", "all_digits"])
@pytest.mark.parametrize("N,B,split", [(64, 3, 16), (64, 1, 1), (128, 2, 4)])
def test_gather_arm_model_matches_keyswitch_ref(N, B, split, kind):
    params, acc, tks, C = _ks_case(N, 16, B, seed=N + B, kind=kind)
    r, ext = _gather_model(acc, tks, params, C, split)
    r0, ext0 = cmux.keyswitch_ref(torch.from_numpy(acc), torch.from_numpy(tks), params)
    np.testing.assert_array_equal(r, r0.numpy())
    np.testing.assert_array_equal(ext, ext0.numpy())
    if kind == "zero_digits":
        assert not ext[1].any() and not r.any()
    if kind == "all_digits":
        assert (ext[1] == N * 8).all()


@pytest.mark.parametrize("kind", ["random", "all_digits"])
def test_mma_arm_model_matches_keyswitch_ref(kind):
    """N = 64 in two splits, 19 samples (a full and a ragged warp tile)."""
    params, acc, tks, C = _ks_case(64, 16, 19, seed=5, kind=kind)
    r, ext = _mma_model(acc, tks, params, C, split=2)
    r0, ext0 = cmux.keyswitch_ref(torch.from_numpy(acc), torch.from_numpy(tks), params)
    np.testing.assert_array_equal(r, r0.numpy())
    np.testing.assert_array_equal(ext, ext0.numpy())


def test_keyswitch_wrapper_on_cpu_is_the_plain_version():
    params, acc, tks, C = _ks_case(64, 16, 3, seed=1)
    cmux.reset_launches()
    r, ext = cmux.keyswitch(torch.from_numpy(acc), torch.from_numpy(tks), params)
    r0, ext0 = cmux.keyswitch_ref(torch.from_numpy(acc), torch.from_numpy(tks), params)
    assert torch.equal(r, r0) and torch.equal(ext, ext0)
    assert r.shape == (3, C) and ext.shape == (2, 3)
    assert cmux.LAUNCHES["keyswitch"] == 0          # a CPU tensor launches nothing


# ------------------------------------------- model of the pass-wise transforms

def _pad(e):
    return e + (e >> 4)


def _lazy_mul(x, w, w_sh, p):
    """lazy_mul of ntt_passes.cuh in uint32 arithmetic: x * w mod p up
    to one p, for any 32-bit x."""
    assert 0 <= x < 2 ** 32
    r = (x * w - ((x * w_sh) >> 32) * p) % 2 ** 32
    assert r < 2 * p and r % p == x * w % p
    return r


def _fold(x, m):
    assert 0 <= x < 2 * m
    return min(x, (x - m) % 2 ** 32)


def _fwd_pass(v, s0, hi, tabs, p):
    """fwd_pass of ntt_passes.cuh on one thread's 8 values in [0, 4p)."""
    psi, psi_sh = tabs["psi_br"], tabs["psi_br_shoup"]
    for a in range(3):
        half = 4 >> a
        for j in range(8):
            if j & half:
                continue
            i = (1 << (s0 + a)) + (hi << a) + (j >> (3 - a))
            x = _fold(v[j], 2 * p)
            wv = _lazy_mul(v[j + half], int(psi[i]), int(psi_sh[i]), p)
            v[j], v[j + half] = x + wv, x + 2 * p - wv
            assert v[j] < 4 * p < 2 ** 32 and 0 <= v[j + half] < 4 * p


def _fwd_tail(v, tail, g, N, tabs, p):
    """fwd_tail of ntt_passes.cuh: the last `tail` forward stages on the
    4 neighbouring values of group g."""
    psi, psi_sh = tabs["psi_br"], tabs["psi_br_shoup"]
    for a in range(2 - tail, 2):
        half = 2 >> a
        for j in range(4):
            if j & half:
                continue
            i = (N >> (2 - a)) + (g << a) + (j >> (2 - a))
            x = _fold(v[j], 2 * p)
            wv = _lazy_mul(v[j + half], int(psi[i]), int(psi_sh[i]), p)
            v[j], v[j + half] = x + wv, x + 2 * p - wv
            assert v[j] < 4 * p < 2 ** 32 and 0 <= v[j + half] < 4 * p


def _inv_pass(v, lt0, a_first, hi, N, logN, tabs, p):
    """inv_pass of ntt_passes.cuh on one thread's 4 values in [0, 2p)."""
    ipsi, ipsi_sh = tabs["ipsi_br"], tabs["ipsi_br_shoup"]
    for a in range(a_first, 2):
        half, lt = 1 << a, lt0 + a
        for j in range(4):
            if j & half:
                continue
            x, y = v[j], v[j + half]
            assert x < 2 * p and y < 2 * p
            if lt == logN - 1:
                v[j] = _fold(_lazy_mul(x + y, int(tabs["n_inv"]), int(tabs["n_inv_shoup"]), p), p)
                v[j + half] = _fold(_lazy_mul(x + 2 * p - y, int(tabs["ipsi1_ninv"]),
                                              int(tabs["ipsi1_ninv_shoup"]), p), p)
            else:
                i = (N >> (lt + 1)) + hi * (2 >> a) + (j >> (a + 1))
                v[j] = _fold(x + y, 2 * p)
                v[j + half] = _lazy_mul(x + 2 * p - y, int(ipsi[i]), int(ipsi_sh[i]), p)


def _forward_model(x, N, p):
    """One row through the kernel's forward transform: the passes of three
    stages over the padded shared-memory row (the first from registers), then
    the stages left over (logN % 3) on groups of 4 neighbours, as the MAC
    does them. The result is in [0, 4p)."""
    logN = N.bit_length() - 1
    tail = logN % 3
    tabs = ntt.ntt_tables(N, p)
    row = [None] * (N + (N >> 4))
    eighth = N >> 3
    for s0 in range(0, logN - tail, 3):
        lu = logN - s0 - 3
        for q in range(eighth):
            hi = q >> lu
            base = (hi << (lu + 3)) + (q & ((1 << lu) - 1))
            if s0 == 0:
                assert base == q and (1 << lu) == eighth
                v = [int(x[base + (j << lu)]) for j in range(8)]
            else:
                v = [row[_pad(base + (j << lu))] for j in range(8)]
            _fwd_pass(v, s0, hi, tabs, p)
            for j in range(8):
                row[_pad(base + (j << lu))] = v[j]
    out = []
    for g in range(N >> 2):
        v = [row[_pad(4 * g + j)] for j in range(4)]
        _fwd_tail(v, tail, g, N, tabs, p)
        out += v
    return np.array(out, np.int64)


def _inverse_model(xhat, N, p):
    """One row (values in [0, 2p)) through the kernel's inverse passes: pass 1
    in registers on the 4 neighbouring elements the MAC produced, the last
    pass into natural order, in [0, p)."""
    logN = N.bit_length() - 1
    tabs = ntt.ntt_tables(N, p)
    row = [None] * (N + (N >> 4))
    out = [None] * N
    quarter = N >> 2
    for q in range(quarter):
        v = [int(xhat[4 * q + j]) for j in range(4)]
        _inv_pass(v, 0, 0, q, N, logN, tabs, p)
        for j in range(4):
            row[_pad(4 * q + j)] = v[j]
    for l0 in range(2, logN, 2):
        l0e = min(l0, logN - 2)
        for q in range(quarter):
            hi = q >> l0e
            base = (hi << (l0e + 2)) + (q & ((1 << l0e) - 1))
            v = [row[_pad(base + (j << l0e))] for j in range(4)]
            _inv_pass(v, l0e, l0 - l0e, hi, N, logN, tabs, p)
            for j in range(4):
                if l0 + 2 >= logN:
                    out[base + (j << l0e)] = v[j]
                else:
                    row[_pad(base + (j << l0e))] = v[j]
    return np.array(out, np.int64)


def _mac_model(rows, key, key_sh, p):
    """The kernel's MAC: rows in [0, 4p) against one output's key rows, the
    running sum folded into [0, 2p)."""
    out = []
    for i in range(len(rows[0])):
        z = 0
        for r in range(len(rows)):
            z = _fold(z + _lazy_mul(int(rows[r][i]), int(key[r][i]), int(key_sh[r][i]), p), 2 * p)
        out.append(z)
    return np.array(out, np.int64)


@pytest.mark.parametrize("p", ntt.PRIMES)
@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024])
def test_passwise_transforms_match_ntt(N, p):
    rng = np.random.RandomState(N)
    x = rng.randint(0, p, size=N).astype(np.int64)
    want = ntt.ntt_forward_rows(torch.from_numpy(x)[:, None], N, p)[:, 0].numpy()
    got = _forward_model(x, N, p)
    np.testing.assert_array_equal(got % p, want)
    y = rng.randint(0, p, size=N).astype(np.int64)
    want = ntt.ntt_inverse_rows(torch.from_numpy(y)[:, None], N, p)[:, 0].numpy()
    np.testing.assert_array_equal(_inverse_model(y + p * (y % 2), N, p), want)
    np.testing.assert_array_equal(_inverse_model(got % (2 * p), N, p), x)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024])
def test_padded_row_is_injective_and_fits(N):
    idx = np.array([_pad(e) for e in range(N)])
    assert len(set(idx.tolist())) == N and idx.max() < N + (N >> 4)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024])
def test_padded_offsets_are_constants_of_the_pass(N):
    """The kernel addresses element base + j*u of a pass as pad(base) +
    pad(j*u), an immediate once the pass is unrolled: that holds for every
    base a forward pass (8 values, base = hi*8u + lo) or an inverse pass
    (4 values, base = hi*4u + lo) uses, lo < u."""
    logN = N.bit_length() - 1
    for values, lus in ((8, [logN - s0 - 3 for s0 in range(0, logN - logN % 3, 3)]),
                        (4, [min(l0, logN - 2) for l0 in range(0, logN, 2)])):
        for lu in lus:
            for q in range(N // values):
                hi, lo = q >> lu, q & ((1 << lu) - 1)
                base = hi * values * (1 << lu) + lo
                for j in range(values):
                    assert _pad(base + (j << lu)) == _pad(base) + _pad(j << lu)


@pytest.mark.parametrize("p", ntt.PRIMES)
def test_signed_digit_residue_equals_offset_correction(p):
    """The kernel transforms digit - Bg/2 as a residue; the plain code and the
    other kernels subtract NTT(Bg/2 * ones) after the transform. Same numbers."""
    N, params = 64, pt.PARAMS_TOY
    rng = np.random.RandomState(3)
    dg = rng.randint(0, params.Bg, size=N).astype(np.int64)
    signed = np.where(dg >= params.halfBg, dg - params.halfBg, dg + p - params.halfBg)
    ones_hat = cmux._twiddle_stack(N, params.halfBg)[ntt.PRIMES.index(p), :, 4].astype(np.int64)
    want = (_forward_model(dg, N, p) - ones_hat) % p
    np.testing.assert_array_equal(_forward_model(signed, N, p) % p, want)
    dec = torch.from_numpy(dg - params.halfBg)
    np.testing.assert_array_equal(
        ntt.ntt_forward_rows((dec % p)[:, None], N, p)[:, 0].numpy(), want)


def test_cmux_step_model_matches_blind_rotate():
    """One whole CMux step as the kernel's four CTAs compute it (digits, forward
    passes, MAC in the bk_ntt layout, inverse passes, CRT) at N = 128, where
    one forward stage is left to the MAC."""
    params = TfheParams(n=2, N=128, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
                        ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0)
    N, rng = params.N, np.random.RandomState(11)
    bk = np.stack([rng.randint(0, p, size=(1, params.kpl, 2, N)).astype(np.uint32)
                   for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(1, 2, N)).astype(np.int32)
    a = 77
    want = bs.blind_rotate(torch.from_numpy(acc), torch.tensor([[a]], dtype=torch.int32),
                           torch.from_numpy(bk), torch.from_numpy(sh), params)[0].numpy()
    accu = acc[0].astype(np.int64) % 2 ** 32
    res = []
    for pi, p in enumerate(ntt.PRIMES):
        rows = []
        for row in range(params.kpl):
            c, d = row >> 1, row & 1
            i = np.arange(N)
            dd = (i - a) % (2 * N)
            neg = dd >= N
            x = accu[c][np.where(neg, dd - N, dd)]
            u = (np.where(neg, -x, x) - accu[c] + params.decomp_offset) % 2 ** 32
            dg = (u >> (32 - (d + 1) * params.bk_Bgbit)) & params.maskMod
            rows.append(_forward_model(
                np.where(dg >= params.halfBg, dg - params.halfBg, dg + p - params.halfBg), N, p))
        out = []
        for o in range(2):
            prod = _mac_model(rows, bk[0, pi, :, o], sh[0, pi, :, o], p)
            out.append(_inverse_model(prod, N, p))
        res.append(np.stack(out))
    delta = ntt.crt_to_i32(torch.from_numpy(res[0]), torch.from_numpy(res[1])).numpy()
    got = (accu + delta.astype(np.int64)) % 2 ** 32
    np.testing.assert_array_equal(got, want.astype(np.int64) % 2 ** 32)


# ---------------------------------------------------------- default devices

def test_keygen_default_device_is_the_card():
    """Without a card keygen(device=None) raises the stated error; with one
    the keys lie on it."""
    calls = [lambda: pt.keygen(pt.PARAMS_TOY, seed=1),
             lambda: pt.keygen_reference(pt.PARAMS_TOY),
             lambda: lwe.noiseless_trivial(1, 4, (2,))]
    if torch.cuda.is_available():
        assert calls[0]().cloud.bk_ntt.device.type == "cuda"
        assert calls[2]().b.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="runs on the card unless the caller passes"):
            call()


def test_keygen_on_cpu_gives_the_same_seeded_keys():
    """device="cpu" draws what keygen drew when "cpu" was its default: the
    same steps on a CPU generator, without the device's resolution."""
    params, seed = pt.PARAMS_TOY, (3, 1, 4)
    sk = pt.keygen(params, seed=seed, device="cpu")
    g = torch.Generator(device="cpu")
    g.manual_seed(keys._seed_int(seed))
    lwe_key = torch.randint(0, 2, (params.n,), generator=g, dtype=torch.int32)
    tlwe_key = torch.randint(0, 2, (params.k, params.N), generator=g, dtype=torch.int32)
    bk_raw = keys.generate_bootstrapping_key(g, lwe_key, tlwe_key, params)
    ks_a, ks_b = keys.generate_keyswitch_key(g, tlwe_key.reshape(params.n_extract), lwe_key,
                                             params)
    for got, want in ((sk.lwe_key, lwe_key), (sk.tlwe_key, tlwe_key), (sk.bk_raw, bk_raw),
                      (sk.ks_a, ks_a), (sk.ks_b, ks_b)):
        np.testing.assert_array_equal(got, want.numpy())
    cloud = keys.cloud_from_raw(params, bk_raw.numpy(), ks_a.numpy(), ks_b.numpy(), "cpu")
    for name in ("bk_ntt", "bk_ntt_shoup", "bk_rows", "ks_table", "ks_table_perm"):
        got, want = getattr(sk.cloud, name), getattr(cloud, name)
        assert got.device.type == "cpu" and torch.equal(got, want), name
    again = pt.keygen(params, seed=seed, device=torch.device("cpu"))
    assert torch.equal(again.cloud.bk_ntt, sk.cloud.bk_ntt)
    assert not torch.equal(pt.keygen(params, seed=(3, 1, 5), device="cpu").cloud.bk_ntt,
                           sk.cloud.bk_ntt)
