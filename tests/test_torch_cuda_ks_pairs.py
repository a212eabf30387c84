"""The key-switch kernels' paired mode on the card (csrc/cmux.cu: output
i < P key-switches the sum of accumulators i and P + i plus (0, b_add),
output i >= P accumulator P + i), against the plain versions: the key switch
alone at both arms, then behind K5 in clusters of four and two and behind
K3/K4, at PARAMS_110 (l = 2) and PARAMS_128 (l = 3, 640 columns); the
unpaired entry (P = 0) equal to its plain version; and whole 16-bit add,
minimum and division captured as CUDA graphs, whose MUX and prefix levels
take the paired kernels, against their eager runs and the CPU's split
route; a MUX and a prefix level above a forced batch cap, in chunks of whole
pairs. Every test needs a CUDA device and skips without one.

This file imports neither jax nor tfhe_tpu; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ks_pairs.py
"""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling
from test_torch_cuda import _i32, _random_bk

pytestmark = pytest.mark.cuda

B_ADD = gates._1_8
PARAMS = {"110": tt.PARAMS_110, "128": tt.PARAMS_128}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pairs(B_out: int, kind: str) -> int:
    """The pairs of B_out outputs: all of them (a MUX: 2 * B_out
    accumulators), or the first ceil(B_out / 2) (a prefix level's (g, p))."""
    return B_out if kind == "mux" else -(-B_out // 2)


def _tks(params, rng, device):
    C = -(-(params.n + 1) // 128) * 128
    return torch.from_numpy(rng.randint(-128, 128, size=(24, params.N, 4 * C))
                            .astype(np.int8)).to(device)


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("kind", ["mux", "prefix"])
@pytest.mark.parametrize("B_out", [1, 16, 17, 30, 128, 129, 300])
@pytest.mark.parametrize("pname", list(PARAMS))
def test_paired_keyswitch_matches_plain(cuda, pname, B_out, kind):
    """The key switch of 2P + R accumulators, P pairs: the planned arm (by
    the B_out = P + R outputs), then the gather and tensor-core arms forced,
    byte-equal to keyswitch_ref with the same pairs; each launch counted
    with B_out samples. The unpaired call is keyswitch_ref without pairs."""
    params = PARAMS[pname]
    P = _pairs(B_out, kind)
    rng = np.random.RandomState(B_out + 1000 * P)
    acc_t = _i32(rng, (2, params.N, B_out + P)).to(cuda)
    tks = _tks(params, rng, cuda)
    want = cmux.keyswitch_ref(acc_t, tks, params, pairs=P, b_add=B_ADD)
    assert want[0].shape[0] == B_out
    cmux.reset_launches()
    got = [cmux.keyswitch(acc_t, tks, params, pairs=P, b_add=B_ADD)]
    acc = cmux._acc_rows(acc_t, params)
    for plan in ((0, 8), (1, 2)):      # (arm, ranges of N): gather, tensor cores
        got.append(cmux._launch_keyswitch(acc, tks, params, plan=plan, pairs=P, b_add=B_ADD))
    plain = cmux.keyswitch(acc_t, tks, params)
    torch.cuda.synchronize()
    assert cmux.LAUNCHES["keyswitch"] == 4
    assert cmux.SAMPLES["keyswitch"] == 3 * B_out + B_out + P
    for g in got:
        assert _equal(g, want), kind
    assert _equal(plain, cmux.keyswitch_ref(acc_t, tks, params))


@pytest.mark.parametrize("pname", list(PARAMS))
def test_pairs_beyond_half_the_accumulators_are_refused(cuda, pname):
    params = PARAMS[pname]
    rng = np.random.RandomState(3)
    acc_t = _i32(rng, (2, params.N, 5)).to(cuda)
    with pytest.raises(ValueError, match="pairs"):
        cmux.keyswitch(acc_t, _tks(params, rng, cuda), params, pairs=3)


# (route, accumulators, kind): K5 in clusters of four (up to 30 samples), of
# two (31-132 at one wave), and K3/K4
ROUTES = [("k5", 30, "mux"), ("k5", 24, "prefix"), ("k5", 64, "mux"), ("k5", 96, "prefix"),
          ("k4", 34, "mux"), ("k4", 300, "prefix")]


@pytest.mark.parametrize("route,B_in,kind", ROUTES)
@pytest.mark.parametrize("pname", list(PARAMS))
def test_paired_mode_behind_the_blind_rotates(cuda, pname, route, B_in, kind):
    """K5 (either cluster) and K4 with the paired key switch, byte-equal to
    their plain versions with the same pairs; n cut to 4 steps. One blind
    rotate of B_in samples, one key switch of B_in - P."""
    params = PARAMS[pname]
    P = B_in // 2 if kind == "mux" else B_in // 3
    rng = np.random.RandomState(B_in + params.bk_l)
    n = 4
    layout = "ntt" if route == "k5" else "rows"
    bk, sh = _random_bk(params, n, rng, cuda, layout=layout)
    acc_t = _i32(rng, (2, params.N, B_in)).to(cuda)
    bara = _i32(rng, (n, B_in), 0, 2 * params.N).to(cuda)
    tks = _tks(params, rng, cuda)
    fused, ref = ((cmux_packed.blind_rotate_packed_ks_fused,
                   cmux_packed.blind_rotate_packed_ks_fused_ref) if route == "k5" else
                  (cmux.blind_rotate_ks_fused, cmux.blind_rotate_ks_fused_ref))
    cmux.reset_launches()
    got = fused(acc_t, bara, bk, sh, tks, params, P, B_ADD)
    want = ref(acc_t, bara, bk, sh, tks, params, P, B_ADD)
    torch.cuda.synchronize()
    assert _equal(got, want) and got[0].shape[0] == B_in - P
    rotate = "blind_rotate_fused_packed" if route == "k5" else "blind_rotate_ks_fused"
    assert (cmux.LAUNCHES[rotate], cmux.SAMPLES[rotate]) == (1, B_in)
    assert (cmux.LAUNCHES["keyswitch"], cmux.SAMPLES["keyswitch"]) == (1, B_in - P)
    if route == "k5":
        cluster = cmux_packed.small_cluster(B_in, params.N, cuda, params.bk_l)
        assert cluster == (4 if B_in <= 30 else 2)


# ------------------------------------------------ whole circuits as graphs

CIRCUITS = {"add16": arith.add, "min16": arith.minimum, "div16": arith.div}


@pytest.fixture(scope="module")
def small16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sk = tt.keygen(tt.PARAMS_SMALL, seed=(16, 2, 7), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    vals = [(1234, 567), (20000, 301), (77, 5)]        # positive: minimum takes them
    cts = [tuple(arith.encrypt_int(sk, np.array([v]), 16, gen, "cuda") for v in pair)
           for pair in vals]
    return sk, sk.cloud.to("cpu"), vals, cts


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_captured_circuits_take_the_paired_kernels(small16, name, monkeypatch):
    """add16, min16 and div16 at PARAMS_SMALL, the prefix arm forced on both
    sides: captured as a graph and replayed on other operands, equal to
    their eager runs (a, b, cv exact) and to the CPU's split route; every
    paired key switch of the card's runs took the kernels, and a replay
    counts the capture's."""
    sk, cpu_cloud, vals, cts = small16
    fn = CIRCUITS[name]
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
        with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
            profiling.reset_counters()
            eager = [fn(*ct, sk.cloud) for ct in cts[1:]]
            torch.cuda.synchronize()
            per_call = bs.PAIR_KS["kernel"] // 2
            assert per_call > 0 and bs.PAIR_KS == {"kernel": 2 * per_call, "split": 0}
        with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
            fn(*cts[0], sk.cloud)                              # the warm-up
            fn(*cts[0], sk.cloud)                              # the capture
            assert arith.GRAPHS.graphs() == 1
            profiling.reset_counters()
            replayed = [fn(*ct, sk.cloud) for ct in cts[1:]]
            torch.cuda.synchronize()
            assert bs.PAIR_KS == {"kernel": 2 * per_call, "split": 0}
        profiling.reset_counters()
        want = [fn(*(c.to("cpu") for c in ct), cpu_cloud) for ct in cts[1:]]
        assert bs.PAIR_KS == {"kernel": 0, "split": 2 * per_call}
    for e, r, w in zip(eager, replayed, want, strict=True):
        for f in ("a", "b", "cv"):
            assert torch.equal(getattr(r, f), getattr(e, f)), f
            assert torch.equal(getattr(e, f).cpu(), getattr(w, f)), f
    truth = {"add16": lambda a, b: a + b, "min16": min, "div16": lambda a, b: a // b}[name]
    for (a, b), r in zip(vals[1:], replayed):
        assert arith.decrypt_int(sk, r).tolist() == [truth(a, b)], (a, b)


@pytest.mark.parametrize("B", [3, 6])
@pytest.mark.parametrize("kind", ["mux", "prefix"])
def test_paired_batch_above_the_cap_goes_in_chunks_of_pairs(small16, monkeypatch, kind, B):
    """With batch_cap() forced to 5, MUX and prefix_combine of B numbers keep
    the paired kernels, in chunks of whole pairs, then the unpaired samples:
    byte-equal to the same gate in one call, and no split key switch."""
    sk = small16[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B)
    rng = np.random.RandomState(B)
    cts = [tt.encrypt_bits(sk, rng.randint(0, 2, size=(B,)).astype(np.int32), gen, "cuda")
           for _ in range(3 if kind == "mux" else 4)]
    gate = gates.MUX if kind == "mux" else gates.prefix_combine

    def outputs():
        out = gate(*cts, sk.cloud)
        return out if isinstance(out, tuple) else (out,)

    whole = outputs()
    monkeypatch.setattr(bs, "batch_cap", lambda device, cloud: 5)
    profiling.reset_counters()
    parts = outputs()
    torch.cuda.synchronize()
    assert bs.PAIR_KS == {"kernel": 1, "split": 0}
    assert cmux.LAUNCHES["keyswitch"] == -(-B // 2) + (-(-B // 5) if kind == "prefix" else 0)
    for p, w in zip(parts, whole, strict=True):
        for f in ("a", "b", "cv"):
            assert torch.equal(getattr(p, f), getattr(w, f)), f
