"""The adders' Sklansky carry network on the card. Where the card's cost
picks the prefix arm (TFHE_TPU_LOOKAHEAD unset), add and sub run Sklansky
over the nbits - 1 carries the sum reads (``arith._prefix_network``), so a
one-number 16-bit add or sub sends no stage over the samples K5 holds in its
clusters of four. Held here: add16 and sub16 at PARAMS_110 on one number on
the auto path, word for word (a, b, cv) equal to the CPU's plain route
running the same network, every K5 launch in clusters of four, and their
graphs' replays equal to their eager runs; div16 on the auto path at
PARAMS_110, decrypted, replayed equal to eager, and at PARAMS_SMALL equal to
the CPU's plain route (at PARAMS_110 the CPU's ~140 stages would take tens
of minutes); the counters ``arith.PREFIX_NETWORKS`` (every chain Sklansky)
and ``core.bootstrap.PAIR_KS`` (every paired key switch in the kernels).
Every test needs a CUDA device and skips without one.

This file imports neither jax nor tfhe_tpu; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sklansky.py
"""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, config
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

NB = 16
OPS = {"add16": (arith.add, lambda a, b: a + b),
       "sub16": (arith.sub, lambda a, b: a - b),
       "div16": (arith.div, lambda a, b: int(np.trunc(a / b)))}
VALUES = [(12345, -6789), (-32767, 3), (-1, 1), (20000, -3)]


def _keys(params, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sk = tt.keygen(params, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed[0])
    cts = [tuple(arith.encrypt_int(sk, np.array([v]), NB, gen, "cuda") for v in pair)
           for pair in VALUES]
    return sk, sk.cloud.to("cpu"), cts


@pytest.fixture(scope="module")
def p110():
    return _keys(tt.PARAMS_110, (18, 1, 10))


@pytest.fixture(scope="module")
def small():
    return _keys(tt.PARAMS_SMALL, (18, 2, 56))


@pytest.fixture
def auto(monkeypatch):
    """The card's own choice of arm and network: TFHE_TPU_LOOKAHEAD unset."""
    monkeypatch.delenv("TFHE_TPU_LOOKAHEAD", raising=False)
    assert config.flag("TFHE_TPU_LOOKAHEAD") == "auto"


def _signed(v: int) -> int:
    v &= (1 << NB) - 1
    return v - (1 << NB) if v >> (NB - 1) else v


def _same(got, want) -> None:
    for f in ("a", "b", "cv"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def _on_cpu(fn, args, cpu_cloud, monkeypatch):
    """fn on the CPU's plain route with the card's network: the prefix arm
    forced, the network Sklansky."""
    with monkeypatch.context() as m:
        m.setattr(arith, "_prefix_network", lambda device: "sklansky")
        with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
            profiling.reset_counters()
            out = fn(*(c.to("cpu") for c in args), cpu_cloud)
            assert arith.PREFIX_NETWORKS["sklansky"] > 0
            assert arith.PREFIX_NETWORKS["kogge_stone"] == 0
            return out, bs.PAIR_KS["split"]


def _eager(fn, args, cloud):
    """fn on the card, eagerly; returns it with the counters it moved."""
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        profiling.reset_counters()
        out = fn(*args, cloud)
        torch.cuda.synchronize()
    return out, {"networks": dict(arith.PREFIX_NETWORKS), "pairs": dict(bs.PAIR_KS),
                 "forms": dict(cmux.FORM_SAMPLES), "launches": dict(cmux.LAUNCHES)}


@pytest.mark.parametrize("name", ["add16", "sub16"])
def test_add_and_sub_on_the_auto_path_equal_the_cpu(p110, auto, monkeypatch, name):
    """One number at PARAMS_110: the auto path takes prefix on Sklansky, one
    chain, four paired key switches in the kernels (three combine levels and
    the last level's MUX), six K5 launches of 30, 21, 21, 21, 14 and 15
    samples, every one in clusters of four; a, b and cv equal the CPU's plain
    route on the same network, and the answer decrypts right."""
    sk, cpu_cloud, cts = p110
    fn, truth = OPS[name]
    out, counted = _eager(fn, cts[0], sk.cloud)
    widths = arith.adder_stages(1, NB, "sklansky")[1]
    assert widths == [30, 21, 21, 21, 14, 15]
    four = cmux_packed.samples_in_flight(sk.params.N, 4, torch.cuda.current_device(),
                                         sk.params.bk_l)
    assert max(widths) <= four
    assert all(cmux_packed.small_cluster(w, sk.params.N, out.a.device, sk.params.bk_l) == 4
               for w in widths)
    assert counted["networks"] == {"kogge_stone": 0, "sklansky": 1}
    assert counted["pairs"] == {"kernel": 4, "split": 0}
    assert counted["launches"]["blind_rotate_fused_packed"] == len(widths)
    k5 = {k: v for k, v in counted["forms"].items() if k[0] == "blind_rotate_fused_packed"}
    assert k5 == {("blind_rotate_fused_packed", sk.params.bk_l)
                  + cmux_packed.CLUSTER_FORMS[4]: sum(widths)}
    a, b = VALUES[0]
    assert arith.decrypt_int(sk, out).tolist() == [_signed(truth(a, b))]
    want, split = _on_cpu(fn, cts[0], cpu_cloud, monkeypatch)
    assert split == 4
    _same(out, want)


@pytest.mark.parametrize("name", ["add16", "sub16", "div16"])
def test_replays_equal_eager_on_the_network(p110, auto, monkeypatch, name):
    """The auto path captured as a graph and replayed on other operands at
    PARAMS_110: each replay equal to the eager run on its operands (a, b, cv
    exact), right answers, and the counters of a replay equal eager's: every
    chain Sklansky (div16: two absolutes and sixteen adds), every paired key
    switch in the kernels (div16: 89)."""
    sk, _, cts = p110
    fn, truth = OPS[name]
    eager = [_eager(fn, ct, sk.cloud) for ct in cts[1:]]
    chains = 18 if name == "div16" else 1
    for _, counted in eager:
        assert counted["networks"] == {"kogge_stone": 0, "sklansky": chains}
        assert counted["pairs"]["split"] == 0 and counted["pairs"]["kernel"] == (
            89 if name == "div16" else 4)
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        fn(*cts[0], sk.cloud)                                  # the warm-up
        fn(*cts[0], sk.cloud)                                  # the capture
        assert arith.GRAPHS.graphs() == 1
        for ct, (want, counted) in zip(cts[1:], eager, strict=True):
            profiling.reset_counters()
            got = fn(*ct, sk.cloud)
            torch.cuda.synchronize()
            assert arith.GRAPHS.counts["replay"] >= 1
            assert dict(arith.PREFIX_NETWORKS) == counted["networks"]
            assert dict(bs.PAIR_KS) == counted["pairs"]
            assert dict(cmux.LAUNCHES) == counted["launches"]
            _same(got, want)
    for (a, b), (out, _) in zip(VALUES[1:], eager):
        assert arith.decrypt_int(sk, out).tolist() == [_signed(truth(a, b))], (a, b)


def test_div16_on_the_auto_path_equals_the_cpu(small, auto, monkeypatch):
    """div16 at PARAMS_SMALL on one number: the auto path (prefix on
    Sklansky: 18 chains) equal, a, b and cv, to the CPU's plain route on the
    same network, every one of its 89 paired key switches in the kernels."""
    sk, cpu_cloud, cts = small
    fn, truth = OPS["div16"]
    out, counted = _eager(fn, cts[0], sk.cloud)
    assert counted["networks"] == {"kogge_stone": 0, "sklansky": 18}
    assert counted["pairs"] == {"kernel": 89, "split": 0}
    want, split = _on_cpu(fn, cts[0], cpu_cloud, monkeypatch)
    assert split == 89
    _same(out, want)
    a, b = VALUES[0]
    assert arith.decrypt_int(sk, out).tolist() == [_signed(truth(a, b))]
