"""The CUDA kernels at PARAMS_128 (gadget length l = 3, n = 630, C = 640
key-switch columns) against their plain-torch versions, on the card: K1-K4 in
both forms the plan holds, K5 in clusters of four and of two, both arms of the
key switch, gate2 through the bootstrap's routing, and a 16-bit add captured
by ``arith.circuit`` and replayed. Every comparison is exact (max |err| 0).
Every test needs a CUDA device and skips without one.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_p128.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, config, gates, ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.keys import bk_rows_layout
from tfhe_tpu_torch.ops import cmux, cmux_packed

pytestmark = pytest.mark.cuda

P128 = tt.PARAMS_128
BATCHES = [1, 30, 31, 256, 265, 2049]
STEPS = 3                   # CMux steps of the kernel tests: the index maps repeat every step


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def keys128(cuda):
    """A random NTT-domain key of STEPS steps in both layouts and a random
    key-switch limb table of C = 640 columns."""
    rng = np.random.RandomState(128)
    P = P128
    bk = np.stack([rng.randint(0, p, size=(STEPS, P.kpl, P.k + 1, P.N)).astype(np.uint32)
                   for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    C = -(-(P.n + 1) // 128) * 128
    tks = rng.randint(-128, 128, size=(P.ks_t * (P.ks_base - 1), P.N, 4 * C)).astype(np.int8)
    put = lambda a: torch.from_numpy(a).to(cuda)          # noqa: E731
    return {"ntt": (put(bk), put(sh)), "rows": (put(bk_rows_layout(bk)), put(bk_rows_layout(sh))),
            "tks": put(tks), "C": C}


def _i32(rng, shape, lo=-2 ** 31, hi=2 ** 31):
    return torch.from_numpy(rng.randint(lo, hi, size=shape).astype(np.int32)).cuda()


def _maxerr(got, want) -> int:
    assert got.dtype == want.dtype and got.shape == want.shape
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


@pytest.mark.parametrize("B", BATCHES)
def test_blind_rotate_kernels_at_params_128(keys128, B):
    """K1, K3 in each form of CMUX_FORMS[3], K4, and K5 alone in clusters of
    four and two and with the key switch, against plain; each launch counted
    under its form."""
    P = dataclasses.replace(P128, n=STEPS)
    rng = np.random.RandomState(B)
    bk, sh = keys128["rows"]
    bkn, shn = keys128["ntt"]
    tks = keys128["tks"]
    dec_t = _i32(rng, (P.kpl, P.N, B), -P.halfBg, P.halfBg)
    acc_t = _i32(rng, (2, P.N, B))
    bara = _i32(rng, (STEPS, B), 0, 2 * P.N)
    cmux.reset_launches()
    errs = {}
    for form in cmux.CMUX_FORMS[3]:
        errs[f"K1 {form}"] = _maxerr(cmux.cmux_delta(dec_t, bk[0], sh[0], P, form=form),
                                     cmux.cmux_delta_ref(dec_t, bk[0], sh[0], P))
        errs[f"K3 {form}"] = _maxerr(cmux.blind_rotate_fused(acc_t, bara, bk, sh, P, form=form),
                                     cmux.blind_rotate_fused_ref(acc_t, bara, bk, sh, P))
    r, ext = cmux.blind_rotate_ks_fused(acc_t, bara, bk, sh, tks, P)
    r2, ext2 = cmux.blind_rotate_ks_fused_ref(acc_t, bara, bk, sh, tks, P)
    errs["K4"] = max(_maxerr(r, r2), _maxerr(ext, ext2))
    acc_p = acc_t.permute(0, 2, 1).reshape(2 * B, P.N // 128, 128).contiguous()
    want = cmux_packed.blind_rotate_fused_packed_ref(acc_p, bara, bkn, shn, P)
    for cluster in (4, 2):
        got = cmux_packed._launch_packed(acc_p.clone(), bara.T.contiguous(), bkn, shn, P,
                                         cluster=cluster)
        errs[f"K5 c{cluster}"] = _maxerr(got, want)
    r, ext = cmux_packed.blind_rotate_packed_ks_fused(acc_t, bara, bkn, shn, tks, P)
    r2, ext2 = cmux_packed.blind_rotate_packed_ks_fused_ref(acc_t, bara, bkn, shn, tks, P)
    errs["K5 + key switch"] = max(_maxerr(r, r2), _maxerr(ext, ext2))
    torch.cuda.synchronize()
    assert errs == dict.fromkeys(errs, 0)
    S, nbuf = cmux.blind_rotate_plan(P.N, 3)
    assert (S, nbuf) == (2, 1)
    assert cmux.FORM_SAMPLES[("blind_rotate_ks_fused", 3, S, nbuf)] == B
    assert cmux.FORM_SAMPLES[("blind_rotate_fused", 3, 1, 0)] == B


@pytest.mark.parametrize("B", BATCHES)
def test_keyswitch_arms_at_params_128(keys128, B):
    """Both arms of the key switch at n = 630 (C = 640), forced, and the
    arm the plan takes, against plain on random digits."""
    P = P128
    rng = np.random.RandomState(B + 1)
    acc_t = _i32(rng, (2, P.N, B))
    tks = keys128["tks"]
    want = cmux.keyswitch_ref(acc_t, tks, P)
    got = [cmux.keyswitch(acc_t, tks, P)]
    acc = cmux._acc_rows(acc_t, P)
    for plan in ((0, 8), (1, 2)):           # (arm, ranges of N): gather, tensor cores
        got.append(cmux._launch_keyswitch(acc, tks, P, plan=plan))
    torch.cuda.synchronize()
    for r, ext in got:
        assert _maxerr(r, want[0]) == 0 and _maxerr(ext, want[1]) == 0


@pytest.fixture(scope="module")
def sk128(cuda):
    return tt.keygen(P128, seed=128, device=cuda)


def _plain_route(monkeypatch):
    """Every wrapper takes its plain version, on the card's tensors."""
    for mod in (cmux, cmux_packed):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: False)


@pytest.mark.parametrize("B", BATCHES)
def test_gate2_at_params_128_through_the_routing(sk128, B, monkeypatch):
    """gate2 on the card, by the route the bootstrap takes for B (K5 or K4,
    the key switch fused or apart), equals the plain route on the card word
    for word and decrypts to the gate's truth."""
    sk = sk128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B)
    rng = np.random.RandomState(B)
    bits = [rng.randint(0, 2, B) for _ in range(2)]
    x, y = (tt.encrypt_bits(sk, v, gen, "cuda") for v in bits)
    kind = ("AND", "XOR", "NOR")[B % 3]
    outs = {}
    for fuse in ("1", "0"):
        with config.overrides(TFHE_TPU_FUSEKS=fuse):
            cmux.reset_launches()
            outs[fuse] = gates.gate2(kind, x, y, sk.cloud)
            torch.cuda.synchronize()
            k5 = bs.small_batch(B, P128)
            assert cmux.LAUNCHES["blind_rotate_fused_packed"] == int(k5)
            assert cmux.LAUNCHES["blind_rotate_ks_fused" if fuse == "1" else "blind_rotate_fused"] \
                == int(not k5)
    with monkeypatch.context() as m:
        _plain_route(m)
        want = gates.gate2(kind, x, y, sk.cloud)
    for got in outs.values():
        assert _maxerr(got.a, want.a) == 0 and _maxerr(got.b, want.b) == 0
    truth = {"AND": np.logical_and, "XOR": np.logical_xor,
             "NOR": lambda u, v: ~np.logical_or(u, v)}[kind](bits[0] == 1, bits[1] == 1)
    np.testing.assert_array_equal(tt.decrypt_bits(sk, outs["1"]), truth.astype(np.int64))


def test_add16_captured_at_params_128_equals_eager(sk128, monkeypatch):
    """A 16-bit add of one number at PARAMS_128 captured by arith.circuit (on
    a key's second call) and replayed on other operands equals its eager runs
    (a, b and cv exact), and the counters, FORM_SAMPLES too, move as eager's."""
    sk = sk128
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    x, y, u, v = (arith.encrypt_int(sk, np.array([w]), 16, gen, "cuda")
                  for w in (1234, -567, 32000, -3))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        eager_xy = arith.add(x, y, sk.cloud)
        cmux.reset_launches()
        eager_uv = arith.add(u, v, sk.cloud)
        torch.cuda.synchronize()
        counts = (dict(cmux.LAUNCHES), dict(cmux.SAMPLES), dict(cmux.FORM_SAMPLES))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        arith.add(x, y, sk.cloud)                                 # the warm-up
        captured = arith.add(x, y, sk.cloud)
        assert arith.GRAPHS.graphs() == 1
        cmux.reset_launches()
        replayed = arith.add(u, v, sk.cloud)
        torch.cuda.synchronize()
        assert (dict(cmux.LAUNCHES), dict(cmux.SAMPLES), dict(cmux.FORM_SAMPLES)) == counts
    for got, want in ((captured, eager_xy), (replayed, eager_uv)):
        for f in ("a", "b", "cv"):
            assert torch.equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(arith.decrypt_int(sk, replayed), [31997])
    assert all(k[1] == 3 for k in counts[2])                      # every launch at l = 3
