"""The counter of K5's stages by cluster, ``ops.cmux_packed.CLUSTERS``, held
on the CPU at PARAMS_TOY (l = 2) and PARAMS_TOY_L3 (l = 3) with the CUDA
library stood in for (as tests/test_torch_tracing_forms.py does it): one count a
K5 launch (a stage, not its samples) under "c4" or "c2", the cluster
``small_cluster`` picks from the samples the card holds at once, on each
route a bootstrap takes to K5 (with the key switch, without it, paired, a
batch above the cap one count a chunk) and none on K3/K4 or the plain route;
a replayed circuit adding what its capture counted (through the recording
stand-in of tests/test_torch_circuit.py); and ``profiling.reset_counters``
zeroing it."""
import dataclasses

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling
from test_torch_circuit import Recording
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

IN_FLIGHT = 30          # samples an H100 holds at once in K5's clusters of four, N = 1024
ZERO = {"c4": 0, "c2": 0}


class _Library:
    """Stands in for the CUDA library: every entry point returns success."""
    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture(scope="module", params=[pt.PARAMS_TOY, pt.PARAMS_TOY_L3], ids=["l2", "l3"])
def sk(request):
    return pt.keygen(request.param, seed=(19, 5, 3), device="cpu")


@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, the library stood in for,
    the card holding IN_FLIGHT samples at once in clusters of four."""
    for mod in (cmux, cmux_packed):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "library", _Library)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(cmux_packed, "samples_in_flight", lambda N, cluster, index, l: IN_FLIGHT)
    monkeypatch.setattr(bs, "card_index", lambda device: 0)


def _bits(sk, B: int, seed: int):
    bits = np.random.RandomState(seed).randint(0, 2, size=B).astype(np.int32)
    return pt.encrypt_bits(sk, bits, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("fuseks", ["1", "0"])
@pytest.mark.parametrize("B,want", [(5, "c4"), (IN_FLIGHT, "c4"), (IN_FLIGHT + 2, "c2")])
def test_one_count_per_bootstrap_call(sk, card, fuseks, B, want):
    """Three bootstraps of B samples are three K5 stages in the cluster the
    card's occupancy gives B, with the key switch in the wrapper or after it;
    a bootstrap without key switch counts the same."""
    x = _bits(sk, B, seed=1)
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        for _ in range(3):
            bs.bootstrap(x, gates.MU, sk.cloud)
    assert cmux_packed.CLUSTERS == {**ZERO, want: 3}
    profiling.reset_counters()
    bs.bootstrap_woks(x, gates.MU, sk.cloud)
    assert cmux_packed.CLUSTERS == {**ZERO, want: 1}


@pytest.mark.parametrize("fuseks", ["1", "0"])
def test_k3_k4_and_the_plain_route_count_nothing(sk, monkeypatch, card, fuseks):
    """Above small_batch_max a bootstrap takes K3/K4, which is no K5 stage;
    off the card (the plain route) nothing launches."""
    monkeypatch.setitem(bs.WAVES, sk.params.bk_l,
                        dataclasses.replace(bs.WAVES[sk.params.bk_l], small_batch_max=0))
    x = _bits(sk, 5, seed=2)
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        bs.bootstrap(x, gates.MU, sk.cloud)
    assert cmux_packed.CLUSTERS == ZERO and cmux.LAUNCHES["blind_rotate_fused_packed"] == 0
    monkeypatch.undo()
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        bs.bootstrap(x, gates.MU, sk.cloud)
    assert cmux_packed.CLUSTERS == ZERO


@pytest.mark.parametrize("fuseks", ["1", "0"])
@pytest.mark.parametrize("B,want", [(4, "c4"), (16, "c2")])
def test_a_paired_bootstrap_counts_once(sk, card, fuseks, B, want):
    """A MUX of B bits is one K5 stage of 2B samples: paired in the wrapper
    on the fused route, a bootstrap without key switch on the other."""
    a, b, c = (_bits(sk, B, seed=s) for s in (2, 3, 4))
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        gates.MUX(a, b, c, sk.cloud)
    assert cmux_packed.CLUSTERS == {**ZERO, want: 1}


def test_a_batch_above_the_cap_counts_each_chunk(sk, card, monkeypatch):
    """9 samples under a cap of 4: chunks of 4, 4 and 1, three stages."""
    monkeypatch.setattr(bs, "CPU_MAX_BATCH", 4)
    profiling.reset_counters()
    bs.bootstrap(_bits(sk, 9, seed=5), gates.MU, sk.cloud)
    assert cmux_packed.CLUSTERS == {**ZERO, "c4": 3}


def test_a_replay_adds_its_captures_counts_and_reset_zeroes_them(sk, card, monkeypatch):
    """A minimum (its MUX paired) run eagerly, then captured and replayed
    through the recording stand-in: the replay counts what the eager call
    counted, a stage a count, though it runs none of the code that counts."""
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(Recording, eager_calls=1))
    gen = torch.Generator().manual_seed(6)
    x, y = (arith.encrypt_int(sk, np.array([v]), 4, gen, "cpu") for v in (5, 3))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1", TFHE_TPU_FUSEKS="1"):
        profiling.reset_counters()
        arith.minimum(x, y, sk.cloud)                 # the first call: eager
        eager = dict(cmux_packed.CLUSTERS)
        arith.minimum(x, y, sk.cloud)                 # captures, then replays
        profiling.reset_counters()
        assert cmux_packed.CLUSTERS == ZERO
        arith.minimum(y, x, sk.cloud)                 # a replay
    assert arith.GRAPHS.counts["capture"] == arith.GRAPHS.counts["replay"] == 1
    assert eager["c4"] > 0 and cmux_packed.CLUSTERS == eager
    entry = next(iter(arith.GRAPHS.entries.values()))
    assert entry.counted["k5_clusters"] == {k: v for k, v in eager.items() if v}
    profiling.reset_counters()
    assert cmux_packed.CLUSTERS == ZERO
