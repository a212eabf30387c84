"""PARAMS_128 (the TFHE library's default 128-bit set) in the port on the CPU:
its derived values and what the kernels' accounting makes of them, the
routing by parameter set (PARAMS_110's unchanged, pinned against the values
it had with one set), and the port's bootstrap and ten gates at the toy set
with PARAMS_128's gadget (PARAMS_TOY_L3: l = 3, Bg = 2^7) word for word
against the benchmark's plain reference (h100_bench/reference.py) on seeded
keys of h100_bench/keys.py."""
import dataclasses
import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.keys import cloud_from_raw
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux, cmux_packed

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "h100_bench")
if BENCH not in sys.path:
    sys.path.append(BENCH)          # the benchmark's modules import each other by name
import keys as K          # noqa: E402
import reference as ref   # noqa: E402


def _roofline():
    spec = importlib.util.spec_from_file_location("h100_bench_roofline",
                                                  os.path.join(BENCH, "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- the set itself

def test_params_128_values_and_derived():
    P = pt.PARAMS_128
    assert (P.n, P.N, P.k, P.bk_l, P.bk_Bgbit, P.ks_basebit, P.ks_t) == (630, 1024, 1, 3, 7, 2, 8)
    assert (P.ks_stdev, P.bk_stdev, P.max_stdev) == (2.0 ** -15, 2.0 ** -25, 0.012467)
    assert P.kpl == 6 and P.Bg == 128 and P.halfBg == 64
    assert P.h == (1 << 25, 1 << 18, 1 << 11)
    assert P.decomp_offset == (64 * ((1 << 25) + (1 << 18) + (1 << 11))) & 0xFFFFFFFF
    assert P.ks_prec_offset == 1 << 15 and P.n_extract == 1024


def test_params_128_sizes_the_kernels_count():
    R, P = _roofline(), pt.PARAMS_128
    assert R.cmux_step_ops(P) == 696320
    assert R.cmux_step_ops(pt.PARAMS_110) == 512000
    assert R.key_bytes(P) == 123863040
    assert R.ks_table_bytes(P) == 62914560
    # C = 640 columns of the key-switch table: n + 1 padded to a multiple of 128
    C = -(-(P.n + 1) // 128) * 128
    assert C == 640
    tks = torch.zeros((P.ks_t * (P.ks_base - 1), P.N, 4 * C), dtype=torch.int8)
    assert cmux._check_tks(tks, P) == 640


def test_params_128_reaches_the_kernels_checks():
    for P in (pt.PARAMS_110, pt.PARAMS_128, pt.PARAMS_TOY_L3):
        cmux._check_params(P)
    for bad in (dataclasses.replace(pt.PARAMS_128, bk_l=4),
                dataclasses.replace(pt.PARAMS_128, k=2),
                dataclasses.replace(pt.PARAMS_128, N=4096)):
        with pytest.raises(ValueError):
            cmux._check_params(bad)


# ---------------------------------------------------------------- routing

# core/bootstrap.py's routing values before they were priced per parameter set
OLD = dict(small_max=858, k5_wave=132, k5_wave_ms=3.6, k5_tail_ms=2.1, k3_wave=264,
           k3_wave_ms=6.2, k5_c4_ms=1.84, glue=0.1)


def _old_k5(B):
    full, tail = divmod(B, OLD["k5_wave"])
    return full * OLD["k5_wave_ms"] + (0.0 if tail == 0 else OLD["k5_tail_ms"]
                                       if 2 * tail <= OLD["k5_wave"] else OLD["k5_wave_ms"])


def _old_k3(B):
    return -(-B // OLD["k3_wave"]) * OLD["k3_wave_ms"]


def _old_small(B):
    return B <= OLD["small_max"] and _old_k5(B) <= _old_k3(B)


def _old_stage(B, in_flight):
    if B <= in_flight:
        rotate = OLD["k5_c4_ms"]
    else:
        rotate = _old_k5(B) if in_flight and _old_small(B) else _old_k3(B)
    return rotate + OLD["glue"]


@pytest.fixture
def card30(monkeypatch):
    """cuda:0 holding 30 samples in K5's clusters of four, with no CUDA call."""
    monkeypatch.setattr(cmux_packed, "samples_in_flight", lambda N, cluster, index, l: 30)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("params", [pt.PARAMS_110, pt.PARAMS_TOY, pt.PARAMS_SMALL,
                                    dataclasses.replace(pt.PARAMS_TOY, bk_l=4, bk_Bgbit=6)],
                         ids=["110", "toy", "small", "cpu_only_l4"])
def test_routing_at_gadget_length_two_is_unchanged(params, card30):
    """small_batch and stage_ms at every batch to 4096, both in-flight counts
    the card gives (30 and none: the CPU's), return what they returned with
    one set; a set the kernels do not take (l = 4, the CPU path only) routes
    so too."""
    for B in range(1, 4097):
        assert bs.small_batch(B, params) is _old_small(B), B
        for in_flight, device in ((30, card30), (0, torch.device("cpu"))):
            assert bs.stage_ms(B, params, device) == _old_stage(B, in_flight), (B, in_flight)
    assert bs.waves(params) == bs.WAVES[2] == bs.Waves(*OLD.values())


def test_routing_at_params_128_follows_its_sweep(card30):
    """At PARAMS_128 the route is the one measured faster at each batch of the
    card's sweep (K5 up to 198 and on the short last waves, K3/K4 else), and a
    stage costs more than at PARAMS_110."""
    P = pt.PARAMS_128
    assert bs.waves(P) is bs.WAVES[3]
    k5 = (1, 30, 31, 66, 132, 133, 192, 265, 396, 529)
    k3 = (200, 256, 264, 528, 660, 792, 859, 1056, 2048, 4096)
    assert all(bs.small_batch(B, P) for B in k5)
    assert not any(bs.small_batch(B, P) for B in k3)
    for B in (1, 30, 31, 256, 2048):
        assert bs.stage_ms(B, P, card30) > bs.stage_ms(B, pt.PARAMS_110, card30)
    # the adders' arm is priced at the keys' set
    assert arith._latency_policy(1, 16, card30, SimpleNamespace(params=P)) is True
    assert arith._latency_policy(64, 16, card30, SimpleNamespace(params=P)) is False
    assert sorted(bs.WAVES) == sorted(cmux.CMUX_FORMS) == [2, 3]


# ------------------------------------------- the port against the reference

def _setup(P, seed):
    keys = K.keygen(K.Params(P.n, P.N, P.k, P.bk_l, P.bk_Bgbit, P.ks_basebit, P.ks_t,
                             P.ks_stdev, P.bk_stdev), seed, "cpu")
    cloud = cloud_from_raw(P, keys.bk.numpy(), keys.ks_a.numpy(), keys.ks_b.numpy(), "cpu")
    return keys, cloud


@pytest.fixture(scope="module")
def toy_l3():
    return _setup(pt.PARAMS_TOY_L3, 2 ** 31 + 15)


@pytest.mark.parametrize("B", [1, 7, 33])
def test_ten_gates_at_three_levels_equal_the_reference(toy_l3, B):
    keys, cloud = toy_l3
    g = K.generator(B, "cpu", "t")
    bx, by = (torch.randint(0, 2, (B,), generator=g) for _ in range(2))
    x, y = (LweCiphertext(*K.encrypt_bits(keys, v, g)) for v in (bx, by))
    for kind in sorted(ref.GATES):
        out = gates.gate2(kind, x, y, cloud)
        a, b = ref.gate(keys, kind, x.a, x.b, y.a, y.b)
        assert torch.equal(a, out.a) and torch.equal(b, out.b), kind
        bits, _ = K.decrypt_bits(keys, out.a, out.b)
        assert torch.equal(bits, ref.TRUTH[kind](bx, by).to(torch.int32)), kind


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("fuseks", ["0", "1"])
def test_bootstrap_at_three_levels_equals_the_reference(toy_l3, B, fuseks):
    """The bootstrap of a batch by each route (the key switch fused into the
    wrapper or apart), the small-batch one and the other, word for word."""
    keys, cloud = toy_l3
    g = K.generator(100 + B, "cpu", "t")
    x = LweCiphertext(*K.encrypt_bits(keys, torch.randint(0, 2, (B,), generator=g), g))
    mu = torch.tensor(([1 << 28, -(1 << 28), 1 << 29] * B)[:B], dtype=torch.int32)
    want = ref.bootstrap(keys, x.a, x.b, mu)
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        for small in (bs.small_batch(B, cloud.params), not bs.small_batch(B, cloud.params)):
            old = bs.WAVES[3]
            try:
                bs.WAVES[3] = dataclasses.replace(old, small_batch_max=B if small else 0)
                out = bs.bootstrap(x, mu, cloud)
            finally:
                bs.WAVES[3] = old
            assert torch.equal(out.a, want[0]) and torch.equal(out.b, want[1]), small
