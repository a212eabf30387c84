"""The index maps of the blind-rotate kernels at gadget length l = 3
(PARAMS_128's gadget), held on the CPU against the port's plain external
product and blind rotate (``core.bootstrap``).

Nothing here runs the CUDA sources; tests/test_torch_cuda_p128.py checks the
kernels on the card. The models follow the kernels' loops task for task with
numpy arrays standing for the threads of a phase, as
tests/test_torch_blind_rotate_block.py does at l = 2:

- K1-K4 (csrc/extern_product.cuh): a block of S samples still has N/2
  threads a sample; the six digit rows of the forward passes are four row
  groups, whose first two also take rows 4 and 5; a lane of the product takes
  the three rows of one input polynomial, reads its 24-byte chunk (columns
  3*half + rr, both output polynomials) at each of its 4 coefficients, adds a
  third product to a folded sum of two (two products of [0, 2p) fit 32 bits,
  three do not), and trades half of its sums with the neighbouring lane.
- K5 (csrc/blind_rotate_small.cu) in a cluster of four: CTA (prime, h)
  transforms the three digit rows of its polynomial h (two row groups, the
  first also row 2), sends them to CTA (prime, 1-h), and multiplies its own
  three and the three received against key rows r = 3h + k and
  3(1-h) + k - 3.

Tolerance: exact (integers). Lazy-reduction bounds are asserted where the
kernels rely on them.
"""
import numpy as np
import pytest
import torch

from tfhe_tpu_torch import ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.ops import cmux
from tfhe_tpu_torch.params import TfheParams

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

M32 = np.uint64(0xFFFFFFFF)
GL, KOUT = 3, 2
KPL = KOUT * GL


def _params(N, n):
    return TfheParams(n=n, N=N, k=1, bk_l=GL, bk_Bgbit=7, ks_basebit=2, ks_t=8,
                      ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0)


def _case(N, n, B, seed):
    params = _params(N, n)
    rng = np.random.RandomState(seed)
    bk = np.stack([rng.randint(0, p, size=(n, KPL, KOUT, N)).astype(np.uint32)
                   for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(B, KOUT, N)).astype(np.int32)
    bara = rng.randint(0, 2 * N, size=(B, n)).astype(np.int32)
    bara[0, 0] = 0
    return params, bk, sh, acc, bara


def _plain(params, bk, sh, acc, bara):
    out = bs.blind_rotate(torch.from_numpy(acc), torch.from_numpy(bara),
                          torch.from_numpy(bk), torch.from_numpy(sh), params)
    return out.numpy()


# ------------------------------------------------ the arithmetic of a thread

def _pad(e):
    """row_pad of extern_product.cuh."""
    return e + ((e >> 5) << 2)


def _lazy_mul(x, w, w_sh, p):
    assert (x <= M32).all()
    r = (x * w - ((x * w_sh) >> np.uint64(32)) * np.uint64(p)) & M32
    assert (r < 2 * p).all()
    return r


def _fold(x, m):
    assert (x < 2 * m).all()
    return np.minimum(x, (x - np.uint64(m)) & M32)


def _add32(x, y):
    """A uint32 add that must not wrap."""
    s = x + y
    assert (s <= M32).all()
    return s


def _butterfly(v, j, half, w, w_sh, p):
    x = _fold(v[:, j], 2 * p)
    wv = _lazy_mul(v[:, j + half], w, w_sh, p)
    v[:, j], v[:, j + half] = x + wv, x + np.uint64(2 * p) - wv


def _fwd_pass(v, s0, hi, tw, p):
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
    P1, P2 = ntt.PRIMES
    r1p2 = np.where(r1 >= P2, r1 - np.uint64(P2), r1)
    d = np.where(r2 >= r1p2, r2 - r1p2, r2 + np.uint64(P2) - r1p2)
    t = _lazy_mul(d, np.uint64(ntt._INV_P1_MOD_P2), np.uint64(ntt._INV_P1_SHOUP), P2)
    t = np.where(t >= P2, t - np.uint64(P2), t)
    rep = (r1 + np.uint64(P1) * t) & M32
    upper = (t > ntt._T_HALF) | ((t == ntt._T_HALF) & (r1 >= ntt._R1_HALF))
    return np.where(upper, (rep - np.uint64(ntt._M_MOD_2_32)) & M32, rep)


def _digits(a, rot, params, c, d, i):
    """The raw gadget digit in [0, Bg) (level d, before the kernels subtract
    Bg/2) of X^rot * a[c] - a[c] at elements i, one task a row: a uint64[tasks,
    KOUT, N], rot, c, d int[tasks], i int[tasks, 8]."""
    N = params.N
    dd = (i - rot[:, None]) % (2 * N)
    neg = dd >= N
    rows = np.arange(len(rot))[:, None]
    ac = a[np.arange(len(rot)), c]                # [tasks, N]
    x = ac[rows, np.where(neg, dd - N, dd)]
    u = (np.where(neg, (0 - x) & M32, x) - ac[rows, i] + np.uint64(params.decomp_offset)) & M32
    sh = (32 - (d + 1) * params.bk_Bgbit).astype(np.uint64)
    return (u >> sh[:, None]) & np.uint64(params.maskMod)


# ------------------------------------------------ K1-K4: a block of S samples

def k4_model(acc, bara, key, key_sh, params, S):
    """blind_rotate_kernel<LOGN, 3, S, NBUF> over the grid, the key read from
    the bk_rows layout (its buffers hold the same words)."""
    N, (B, n) = params.N, bara.shape
    logN, tail = N.bit_length() - 1, (N.bit_length() - 1) % 3
    RS = N + (N >> 3) + 2
    SS = KPL * RS + 1
    COLS = KPL * KOUT
    SLICE = COLS * N
    flat_key = key.reshape(-1).astype(np.uint64)
    flat_sh = key_sh.reshape(-1).astype(np.uint64)
    t = np.arange(S * N // 2)
    out = acc.copy()
    for first in range(0, B, S):
        live = np.array([first + s < B for s in range(S)])
        a = np.zeros((S, KOUT, N), np.uint64)
        for s in range(S):
            if live[s]:
                a[s] = acc[first + s].astype(np.int64) % 2 ** 32
        for step in range(n):
            rot = np.array([bara[first + s, step] if live[s] else 0 for s in range(S)])
            rows = np.zeros(S * SS, np.uint64)
            res = []
            for pi, p in enumerate(ntt.PRIMES):
                use = 2 * step + pi
                tabs = ntt.ntt_tables(N, p)
                twf = (tabs["psi_br"].astype(np.uint64), tabs["psi_br_shoup"].astype(np.uint64))
                twi = (tabs["ipsi_br"].astype(np.uint64), tabs["ipsi_br_shoup"].astype(np.uint64))
                # forward passes: row group `row` of a sample, rows row + 4*rr < KPL
                q, row, s = t % (N // 8), (t // (N // 8)) % 4, t // (N // 2)
                written = np.zeros(S * SS, np.int64)
                for s0 in range(0, logN - tail, 3):
                    lu = logN - s0 - 3
                    hi = q >> lu
                    for rr in range((KPL + 3) // 4):
                        r = row + 4 * rr
                        on = r < KPL
                        if not on.any():
                            continue
                        tq, tr, ts, th = q[on], r[on], s[on], hi[on]
                        x = ts * SS + tr * RS + _pad((th << (lu + 3)) + (tq & ((1 << lu) - 1)))
                        at = x[:, None] + _pad(np.arange(8) << lu)
                        if s0 == 0:
                            i = tq[:, None] + np.arange(8) * (N // 8)
                            dg = _digits(a[ts], rot[ts], params, tr // GL, tr % GL, i)
                            v = dg + np.uint64(2 * p) - np.uint64(params.halfBg)
                        else:
                            v = rows[at]
                        _fwd_pass(v, s0, th, twf, p)
                        assert len(set(at.reshape(-1).tolist())) == at.size
                        rows[at] = v
                        if s0 == 0:
                            written[at] += 1
                # every element of every digit row of every sample, once
                cover = [written[s_ * SS + r_ * RS + _pad(np.arange(N))]
                         for s_ in range(S) for r_ in range(KPL)]
                assert all((c == 1).all() for c in cover)
                # the product: lane (s, half, iq) takes rows GL*half + rr
                s, half, iq = t % S, (t // S) % 2, t // (S * 2)
                xs = s * SS + _pad(4 * iq)
                x = [rows[(xs + (GL * half + rr) * RS)[:, None] + np.arange(4)]
                     for rr in range(GL)]
                for rr in range(GL):
                    _fwd_tail(x[rr], tail, iq, N, twf, p)
                z = np.zeros((len(t), 4), np.uint64)
                for j in range(4):
                    at = (4 * iq + j) * COLS + 2 * GL * half
                    assert (at % 2 == 0).all()                  # 8-byte pieces
                    idx = use * SLICE + at[:, None] + np.arange(2 * GL)
                    w, sw = flat_key[idx], flat_sh[idx]
                    c = []
                    for pol in range(KOUT):
                        acc_c = _add32(_lazy_mul(x[0][:, j], w[:, pol], sw[:, pol], p),
                                       _lazy_mul(x[1][:, j], w[:, 2 + pol], sw[:, 2 + pol], p))
                        for rr in range(2, GL):
                            acc_c = _add32(_fold(acc_c, 2 * p),
                                           _lazy_mul(x[rr][:, j], w[:, 2 * rr + pol],
                                                     sw[:, 2 * rr + pol], p))
                        c.append(_fold(acc_c, 2 * p))
                    mine = np.where(half == 1, c[1], c[0])
                    send = np.where(half == 1, c[0], c[1])
                    assert ((t ^ S) // 32 == t // 32).all()
                    z[:, j] = _fold(mine + send[t ^ S], 2 * p)
                _inv_pass(z, 0, 0, iq, N, logN, twi, tabs, p)
                at = (xs + half * RS)[:, None] + np.arange(4)
                rows[at] = z
                iq, pol, s = t % (N // 4), (t // (N // 4)) % KOUT, t // (N // 2)
                for l0 in range(2, logN, 2):
                    l0e = min(l0, logN - 2)
                    hi = iq >> l0e
                    base = (hi << (l0e + 2)) + (iq & ((1 << l0e) - 1))
                    at = (s * SS + pol * RS + _pad(base))[:, None] + _pad(np.arange(4) << l0e)
                    zz = rows[at]
                    _inv_pass(zz, l0e, l0 - l0e, hi, N, logN, twi, tabs, p)
                    if l0 + 2 < logN:
                        rows[at] = zz
                    else:
                        res.append(zz)
            delta = _crt(res[0], res[1])
            at = (t // (N // 4) * N + t % (N // 4))[:, None] + np.arange(4) * (N // 4)
            fa = a.reshape(-1)
            fa[at] = (fa[at] + delta) & M32
        for s in range(S):
            if live[s]:
                out[first + s] = a[s].astype(np.uint32).view(np.int32)
    return out


@pytest.mark.parametrize("N,S,B", [(64, 2, 3), (128, 2, 2), (128, 1, 2), (256, 2, 1)])
def test_k4_model_at_three_levels_matches_plain(N, S, B):
    params, bk, sh, acc, bara = _case(N, 2, B, seed=N + S + B)
    want = _plain(params, bk, sh, acc, bara)
    got = k4_model(acc, bara, keys.bk_rows_layout(bk), keys.bk_rows_layout(sh), params, S)
    np.testing.assert_array_equal(got, want)


def test_three_products_overflow_without_the_fold():
    """Why the product folds after two rows: three lazy products of [0, 2p)
    can pass 2^32 with p near 2^30, two cannot."""
    p = max(ntt.PRIMES)
    assert 4 * p <= 2 ** 32 < 6 * p


def test_l3_forms_fit_and_plan():
    """The shared memory of the l = 3 forms as CmuxBlock lays it out, and the
    plan's choice: (2, 2) does not fit a block at N = 1024, (2, 1) does."""
    assert cmux.cmux_smem_bytes(1024, 2, 2, 3) == 301240 > cmux.SMEM_MAX
    assert cmux.cmux_smem_bytes(1024, 2, 1, 3) == 202936 <= cmux.SMEM_MAX
    assert cmux.cmux_smem_bytes(1024, 1, 0, 3) == 68740
    assert cmux.cmux_smem_bytes(1024, 2, 2, 2) == 217240
    assert cmux.blind_rotate_plan(1024, 3) == (2, 1)
    assert cmux.blind_rotate_plan(1024, 2) == (2, 2)
    for N in (64, 128, 256, 512, 1024, 2048):
        S, nbuf = cmux.blind_rotate_plan(N, 3)
        assert (S, nbuf) in cmux.CMUX_FORMS[3]
        assert cmux.cmux_smem_bytes(N, S, nbuf, 3) <= cmux.SMEM_MAX


# ------------------------------------------------ K5: a cluster of four

def k5_cluster4_model(acc, bara, bk, sh, params):
    """blind_rotate_small_kernel<LOGN, 3, 1> for one sample at a time, the
    transforms exact (ntt.py), the rows' and key rows' index maps the kernel's.
    bk/bksh: the bk_ntt layout [n][P][KPL][KOUT][N]."""
    N, (B, n) = params.N, bara.shape
    NT = N // 4                                   # threads of a CTA (NH = 1)
    groups, own_rows = 2, GL
    tid = np.arange(NT)
    row, q = tid // (N // 8), tid % (N // 8)
    out = acc.copy()
    for smp in range(B):
        a = acc[smp].astype(np.int64) % 2 ** 32     # [KOUT, N]
        for j in range(n):
            rot = np.full(NT, bara[smp, j])
            delta = np.zeros((KOUT, N), np.uint64)
            res = {}
            for prime, p in enumerate(ntt.PRIMES):
                # each CTA h: its own rows, in the forward passes' thread map
                made = {}
                for h in range(KOUT):
                    own = np.full((own_rows, N), -1, np.int64)
                    for rr in range((own_rows + groups - 1) // groups):
                        r = row + groups * rr
                        on = r < own_rows
                        i = q[on][:, None] + np.arange(8) * (N // 8)
                        assert (r[on] // GL == 0).all()                 # NH = 1: polynomial h only
                        dg = _digits(a[None].repeat(on.sum(), 0).astype(np.uint64), rot[on],
                                     params, np.full(on.sum(), h), r[on] % GL, i)
                        signed = dg.astype(np.int64) - params.halfBg
                        assert (own[r[on][:, None], i] == -1).all()      # written once
                        own[r[on][:, None], i] = signed % p
                    assert (own >= 0).all()
                    made[h] = np.stack([ntt.ntt_forward_np(own[r].astype(np.uint64), N, p)
                                        for r in range(own_rows)])
                # the exchange: CTA h receives CTA 1-h's rows; MAC over k < 2*GL
                for h in range(KOUT):
                    recv = made[1 - h]
                    z = np.zeros(N, np.uint64)
                    for k in range(KPL):
                        r = GL * h + k if k < GL else GL * (1 - h) + k - GL
                        src = made[h][k] if k < GL else recv[k - GL]
                        z = (z + src * bk[j, prime, r, h].astype(np.uint64)) % np.uint64(p)
                    inv = ntt.ntt_inverse(torch.from_numpy(z.astype(np.int64)), N, p)
                    res[prime, h] = inv.numpy().astype(np.uint64)
            for h in range(KOUT):
                delta[h] = _crt(res[0, h].astype(np.uint64), res[1, h].astype(np.uint64))
            a = (a + delta.astype(np.int64)) % 2 ** 32
        out[smp] = a.astype(np.uint32).view(np.int32)
    return out


@pytest.mark.parametrize("N,B", [(64, 2), (128, 1)])
def test_k5_cluster_of_four_row_split_matches_plain(N, B):
    params, bk, sh, acc, bara = _case(N, 2, B, seed=3 * N + B)
    want = _plain(params, bk, sh, acc, bara)
    np.testing.assert_array_equal(k5_cluster4_model(acc, bara, bk, sh, params), want)
