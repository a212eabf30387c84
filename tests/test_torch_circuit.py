"""tfhe_tpu_torch.arith.circuit: whole integer circuits captured once as a
CUDA graph and replayed, held here on the CPU.

A CUDA graph has no CPU meaning, so the policy (a key's first
CAPTURE_AFTER calls eager, the next captures, later ones replay, least
recently used out), the plans an eager warm-up hands to the capture, the
cache key, the
eager cases (CPU tensors, keyword arguments, nested calls), the launch
counters and the copies in and out of a graph's own tensors are held through
a recording stand-in for the graph object: it runs the circuit where the card
would record it, and again where the card would replay it. The stand-in
replaces ``arith.GRAPHS``, the one seam. With TFHE_TPU_CIRCUIT_JIT=1, add,
mul_plain (a static argument) and div through the stand-in's capture and
replay equal ``tfhe_tpu``'s jitted circuits at PARAMS_TOY on 4-bit operands:
a and b exact, cv to rtol 1e-6. The card's own graphs are held by
tests/test_torch_cuda.py and chip_smoke.py's [graph] phase."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tfhe_tpu import arith as ja
from tfhe_tpu import config as jconfig
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys, lwe
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 4


class Recording:
    """Stand-in for ``arith.CudaGraph`` on CPU tensors: capture runs the
    circuit once (the outputs it returns are the graph's outputs), replay
    runs it again on the graph's input tensors and writes the results into
    those outputs, and neither leaves a count in the registered counters
    (the graph's are counted by ``CircuitGraphs``)."""
    device_type = "cpu"
    log: list = []

    def __init__(self, device):
        self.pool_bytes = 0

    def capture(self, run):
        Recording.log.append("capture")
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        Recording.log.append("replay")
        saved = profiling.snapshot()
        new = self.run()
        profiling.counts_since(saved)
        for o, n in zip(*((v,) if isinstance(v, LweCiphertext) else v for v in (self.out, new))):
            for f in ("a", "b", "cv"):
                getattr(o, f).copy_(getattr(n, f))


@pytest.fixture
def graphs(monkeypatch):
    """arith.GRAPHS replaced by a cache of recording stand-ins that capture
    on a key's second call (one eager call, the warm-up), with
    TFHE_TPU_CIRCUIT_JIT=1."""
    Recording.log = []
    g = arith.CircuitGraphs(Recording, max_graphs=3, eager_calls=1)
    monkeypatch.setattr(arith, "GRAPHS", g)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        yield g


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def _assert_same(got: LweCiphertext, want) -> None:
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


def _random_ct(seed: int, shape=(2, NB), n: int = 8) -> LweCiphertext:
    rng = np.random.RandomState(seed)
    return LweCiphertext(
        torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=shape + (n,)).astype(np.int32)),
        torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)),
        torch.from_numpy(rng.rand(*shape).astype(np.float32)))


@pytest.fixture(scope="module")
def toy(toy_keys):
    """JAX toy keys, the port's key set from the same raw keys, and two pairs
    of 4-bit operands encrypted by tfhe_tpu (capture inputs, replay inputs)."""
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    vals = [(np.array([5, -3]), np.array([3, 2])), (np.array([-7, 6]), np.array([2, -4]))]
    cts = [tuple(ja.encrypt_int(toy_keys, v, NB, seed=40 + 2 * i + j) for j, v in enumerate(p))
           for i, p in enumerate(vals)]
    return toy_keys, psk, vals, cts


# ------------------------------------------------------------------ config

def test_circuit_jit_enabled(monkeypatch):
    """0/1 force, auto is on for CUDA tensors only; on CPU tensors the
    circuit runs eagerly whatever the flag says (test_cpu_tensors_run_eagerly)."""
    monkeypatch.delenv("TFHE_TPU_CIRCUIT_JIT", raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not config.circuit_jit_enabled(cpu)
    assert config.circuit_jit_enabled(cuda)
    for v, on in (("0", False), ("1", True)):
        with config.overrides(TFHE_TPU_CIRCUIT_JIT=v):
            assert config.circuit_jit_enabled(cpu) is on
            assert config.circuit_jit_enabled(cuda) is on
    monkeypatch.setenv("TFHE_TPU_CIRCUIT_JIT", "0")
    assert not config.circuit_jit_enabled(cuda)


def test_policy_fingerprint_moves_with_every_route(monkeypatch):
    """A circuit's key moves with every flag of config and every routing
    value of core.bootstrap.route_fingerprint; the routing values move that
    fingerprint itself."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=1, device="cpu")
    x, y = _random_ct(1), _random_ct(2)

    def key():
        return arith.circuit_key(arith.add.__wrapped__, (x, y, sk.cloud), (), x.device)[0]

    base, route = key(), bs.route_fingerprint("cpu", sk.cloud)
    assert key() == base and base[1][4:] == route
    for name, value in (("TFHE_TPU_LOOKAHEAD", "1"), ("TFHE_TPU_SEPTET", "1"),
                        ("TFHE_TPU_FUSEKS", "1"), ("TFHE_TPU_NOISE_MODEL", "tracked")):
        with config.overrides(**{name: value}):
            assert key() != base, name
    for module, name, value in ((cmux, "KS_GATHER_MAX", 0), (bs, "CPU_MAX_BATCH", 7)):
        with monkeypatch.context() as m:
            m.setattr(module, name, value)
            assert key() != base and bs.route_fingerprint("cpu", sk.cloud) != route, name
    for l, field, value in ((2, "small_batch_max", 100), (2, "k5_c4_ms", 2.5),
                            (2, "stage_glue_ms", 0.5), (3, "k3_wave_ms", 9.0)):
        with monkeypatch.context() as m:
            m.setitem(bs.WAVES, l, dataclasses.replace(bs.WAVES[l], **{field: value}))
            assert key() != base, (l, field)
            assert bs.route_fingerprint("cpu", sk.cloud) != route, (l, field)
    assert key() == base


# ------------------------------------------------------------------ the adders' arm

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
IN_FLIGHT = 30          # samples an H100 holds at once in K5's clusters of four, N = 1024
P110 = pt.PARAMS_110


@pytest.fixture
def card(monkeypatch):
    """An H100 as the routes see it, with no CUDA call: K5 holds IN_FLIGHT
    samples in clusters of four (cmux_packed.samples_in_flight), and the
    current card is 0. Returns the list of what was asked."""
    asked = []
    monkeypatch.setattr(cmux_packed, "samples_in_flight",
                        lambda N, cluster, index, l=2: asked.append((N, cluster, index, l))
                        or IN_FLIGHT)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return asked


@pytest.mark.parametrize("numbers,nbits,prefix", [
    (1, 16, True), (2, 16, True), (4, 16, True), (1, 32, True), (1, 8, True),
    (5, 16, True), (7, 16, False), (32, 16, False), (64, 16, False), (1, 4, False)])
def test_adder_arm_by_the_cards_cost(monkeypatch, card, numbers, nbits, prefix):
    """On CUDA the arm whose stages cost less on the card: prefix for a few
    numbers, ripple for many (and where the stage counts tie, as at 4 bits);
    on the CPU ripple, as tfhe_tpu. A function of its arguments, the
    routing constants and what the card holds in flight (the fixture's)."""
    monkeypatch.delenv("TFHE_TPU_LOOKAHEAD", raising=False)
    cloud = SimpleNamespace(params=P110)
    assert arith._latency_policy(numbers, nbits, CUDA, cloud) is prefix
    assert arith._latency_policy(numbers, nbits, "cuda:1", cloud) is prefix
    assert arith._latency_policy(numbers, nbits, CPU, cloud) is False
    assert jconfig.lookahead_enabled(numbers, nbits) is False
    for v in ("0", "1"):
        with config.overrides(TFHE_TPU_LOOKAHEAD=v):
            for device in (CUDA, CPU):
                assert arith._latency_policy(numbers, nbits, device, cloud) is (v == "1")


def test_adder_stages_and_their_prices(card):
    """The stages each arm sends to bootstrap, and what a stage costs by the
    route its batch takes: K5 in clusters of four up to IN_FLIGHT, then the
    waves small_batch compares, then K3/K4's waves."""
    assert arith.adder_stages(1, 16) == ([2] * 16, [32, 45, 42, 36, 24, 15])
    assert arith.adder_stages(3, 4) == ([6] * 4, [24, 27, 18, 9])
    assert arith.adder_stages(2, 1) == ([4], [4])
    w = bs.WAVES[2]
    glue = w.stage_glue_ms
    assert bs.in_flight(CUDA, P110) == IN_FLIGHT and bs.in_flight(CPU, P110) == 0
    assert (bs.stage_ms(1, P110, CUDA) == bs.stage_ms(30, P110, CUDA)
            == w.k5_c4_ms + glue)
    assert bs.stage_ms(31, P110, CUDA) == w.k5_tail_ms + glue
    assert bs.stage_ms(132, P110, CUDA) == w.k5_wave_ms + glue
    assert bs.stage_ms(264, P110, CUDA) == w.k3_wave_ms + glue
    assert bs.stage_ms(1024, P110, CUDA) == 4 * w.k3_wave_ms + glue
    big = dataclasses.replace(P110, N=2048)                      # no K5 (N > its limit)
    assert bs.in_flight(CUDA, big) == 0
    assert bs.stage_ms(1, big, CUDA) == bs.stage_ms(1, P110, CPU) == w.k3_wave_ms + glue


def test_adder_decisions_are_counted(monkeypatch, card):
    """_latency_policy counts each decision in ADDER_ARMS; on CUDA it prices
    the stages by how many samples the card holds in clusters of four
    (core.bootstrap.in_flight, through cmux_packed.samples_in_flight, cached
    there), on the CPU or under the forced flag it asks nothing; the forced
    flag wins on either."""
    monkeypatch.delenv("TFHE_TPU_LOOKAHEAD", raising=False)
    before = dict(arith.ADDER_ARMS)
    cloud = SimpleNamespace(params=pt.PARAMS_110)
    assert arith._latency_policy(1, 16, "cuda:0", cloud) is True
    assert arith._latency_policy(64, 16, "cuda:0", cloud) is False
    assert card and set(card) == {(1024, 4, 0, 2)}
    card.clear()
    assert arith._latency_policy(1, 16, "cpu", cloud) is False
    with config.overrides(TFHE_TPU_LOOKAHEAD="0"):
        assert arith._latency_policy(1, 16, "cuda:0", cloud) is False
    with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
        assert arith._latency_policy(64, 16, "cpu", cloud) is True
    assert card == []
    assert {k: arith.ADDER_ARMS[k] - v for k, v in before.items()} == {"prefix": 2, "ripple": 3}


def test_replays_add_the_adder_decisions_of_their_capture(graphs):
    """A captured circuit's decisions count on every replay, as its launches
    do, and once a call whatever the mode: the capture's own run adds none."""
    before = dict(arith.ADDER_ARMS)
    cloud = SimpleNamespace(params=pt.PARAMS_TOY)

    @arith.circuit
    def two_adds(x, cloud):
        arith._latency_policy(1, NB, x.device, cloud)
        arith._latency_policy(2, NB, x.device, cloud)
        return LweCiphertext(x.a + 1, x.b, x.cv)

    x = _random_ct(1)
    counts = []
    for _ in range(4):
        two_adds(x, cloud)
        counts.append({k: arith.ADDER_ARMS[k] - v for k, v in before.items()})
    assert Recording.log == ["capture", "replay", "replay", "replay"]
    assert [c["ripple"] for c in counts] == [2, 4, 6, 8] and counts[-1]["prefix"] == 0
    entry = next(iter(graphs.entries.values()))
    assert entry.counted["adder_arms"] == {"ripple": 2}


def test_replays_carry_a_counter_no_module_names(graphs, monkeypatch):
    """A counter registered through utils.profiling, which arith names
    nowhere: the capture leaves it as it was, each replay adds what the
    capture counted, and reset_counters() zeroes it with the others."""
    monkeypatch.setattr(profiling, "_COUNTERS", dict(profiling._COUNTERS))
    bumps = profiling.counter("test.bumps", ("bump",))
    seen = []

    class Watching(Recording):
        def replay(self):
            seen.append(dict(bumps))
            super().replay()

    graphs.graph = Watching

    @arith.circuit
    def bump(x, cloud):
        bumps["bump"] += 3
        bumps["x"] = bumps.get("x", 0) + 1
        return LweCiphertext(x.a + 1, x.b, x.cv)

    x, cloud = _random_ct(1), object()
    counts = []
    for _ in range(4):                          # eager, capture and replay, replay, replay
        bump(x, cloud)
        counts.append(dict(bumps))
    assert seen[0] == {"bump": 3, "x": 1}       # right after the capture: as it was
    assert counts == [{"bump": 3 * i, "x": i} for i in range(1, 5)]
    entry = next(iter(graphs.entries.values()))
    assert entry.counted["test.bumps"] == {"bump": 3, "x": 1}
    profiling.reset_counters()
    assert bumps == {"bump": 0} and not any(cmux.LAUNCHES.values())


# ------------------------------------------------------------------ the key

def test_circuit_key():
    """Same shapes give the same key; a different shape, static int, cloud
    key or flag gives another; a number outside static_argnums is refused."""
    f = arith.mul_plain.__wrapped__
    cloud, other = object(), object()
    x, y = _random_ct(1), _random_ct(2)
    key, by_id = arith.circuit_key(f, (x, 3, cloud), {1}, x.device)
    assert by_id == [cloud]
    assert arith.circuit_key(f, (y, 3, cloud), {1}, x.device)[0] == key
    for args in ((_random_ct(3, (3, NB)), 3, cloud), (_random_ct(3, n=9), 3, cloud),
                 (x, 5, cloud), (x, 3, other)):
        assert arith.circuit_key(f, args, {1}, x.device)[0] != key
    with config.overrides(TFHE_TPU_SEPTET="1"):
        assert arith.circuit_key(f, (x, 3, cloud), {1}, x.device)[0] != key
    assert arith.circuit_key(arith.add.__wrapped__, (x, y, cloud), (), x.device)[0] != key
    with pytest.raises(TypeError, match="static_argnums"):
        arith.circuit_key(f, (x, 3, cloud), (), x.device)


# ------------------------------------------------------------------ the policy

def _bump_circuit():
    """A decorated stand-in circuit: x + 1 on a and b, one counted launch of
    the key switch on the batch; `runs` counts how often its body ran."""
    runs = []

    @arith.circuit
    def bump(x, cloud):
        runs.append(1)
        cmux.count_launch("keyswitch", x.b.numel())
        return LweCiphertext(x.a + 1, x.b + 1, x.cv)

    return bump, runs


def test_first_second_later_calls(graphs):
    """The first call runs eagerly, the second captures and replays, later
    calls replay on their own inputs; the launch counters move as eager
    calls would move them; results are copies, never shared."""
    bump, runs = _bump_circuit()
    cloud = object()
    x, y = _random_ct(1), _random_ct(2)
    cmux.reset_launches()
    first = bump(x, cloud)
    assert (Recording.log, len(runs), graphs.graphs()) == ([], 1, 0)
    second = bump(x, cloud)
    assert Recording.log == ["capture", "replay"] and graphs.graphs() == 1
    third = bump(y, cloud)
    fourth = bump(y, cloud)
    assert Recording.log == ["capture", "replay", "replay", "replay"]
    assert cmux.LAUNCHES["keyswitch"] == 4 and cmux.SAMPLES["keyswitch"] == 4 * 2 * NB
    for got, src in ((first, x), (second, x), (third, y), (fourth, y)):
        assert torch.equal(got.a, src.a + 1) and torch.equal(got.b, src.b + 1)
    entry = next(iter(graphs.entries.values()))
    ptrs = {t.data_ptr() for o in (second, third, fourth, entry.out) for t in (o.a, o.b)}
    assert len(ptrs) == 8                       # no result shares a tensor
    assert entry.refs == (cloud,)               # the graph holds its cloud key
    assert entry.counted["launches"] == {"keyswitch": 1}
    assert entry.counted["samples"] == {"keyswitch": 2 * NB}


def test_least_recently_used_key_goes_first(graphs):
    """At most max_graphs (3) keys, graphs and first calls together; an
    evicted key starts again from an eager first call."""
    bump, runs = _bump_circuit()
    cloud = object()
    xs = [_random_ct(i, (i, NB)) for i in range(1, 5)]
    for x in xs[:3]:
        bump(x, cloud)
        bump(x, cloud)
    assert graphs.graphs() == 3
    bump(xs[0], cloud)                          # the first key is used again
    bump(xs[3], cloud)                          # a fourth key evicts the second
    assert len(graphs.entries) == 3 and graphs.graphs() == 2
    del Recording.log[:]
    bump(xs[1], cloud)
    assert Recording.log == []                  # a first call again: eager
    bump(xs[0], cloud)
    assert Recording.log == ["replay"]


def test_kwargs_and_nested_calls_run_eagerly(graphs, toy):
    """Keyword arguments run eagerly; absolute's inner add (a decorated
    circuit) runs inside absolute's warm-up, capture and replays, and is never
    a key of its own."""
    _, psk, vals, cts = toy
    x = _ct(cts[0][0])
    for _ in range(3):
        arith.add(x, x, cloud=psk.cloud)
    assert Recording.log == [] and len(graphs.entries) == 0
    outs = [arith.absolute(x, psk.cloud) for _ in range(3)]
    assert Recording.log == ["capture", "replay", "replay"]
    assert [k[0] for k in graphs.entries] == [arith.absolute.__wrapped__]
    for out in outs:
        np.testing.assert_array_equal(arith.decrypt_int(psk, out), np.abs(vals[0][0]))


def test_cpu_tensors_run_eagerly():
    """With the graphs of the card (arith.GRAPHS as the package builds it) and
    TFHE_TPU_CIRCUIT_JIT=1, CPU tensors never reach a graph."""
    bump, runs = _bump_circuit()
    x, cloud = _random_ct(1), object()
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        for _ in range(3):
            bump(x, cloud)
    assert len(runs) == 3
    assert all(k[0] is not bump.__wrapped__ for k in arith.GRAPHS.entries)


def test_a_failed_capture_raises(graphs):
    """No quiet fallback: a capture that fails, or a circuit that returns
    something other than ciphertexts, raises; the key then starts again from
    an eager first call, and the next capture raises again."""
    class Failing(Recording):
        def capture(self, run):
            raise RuntimeError("capture refused")

    bump, runs = _bump_circuit()
    cloud, x = object(), _random_ct(1)
    graphs.graph = Failing
    cmux.reset_launches()
    for _ in range(2):
        bump(x, cloud)                                         # eager
        with pytest.raises(RuntimeError, match="capture refused"):
            bump(x, cloud)
    assert len(runs) == 2 and cmux.LAUNCHES["keyswitch"] == 2 and graphs.graphs() == 0

    @arith.circuit
    def bits(x, cloud):
        return x.b

    graphs.graph = Recording
    bits(x, cloud)
    with pytest.raises(TypeError, match="ciphertexts"):
        bits(x, cloud)


def test_capture_keeps_what_it_reads_alive():
    """Inside core/lwe.keeping, every cached plan a circuit reads (index
    plans, constant bits) is put in the circuit's own dict and read back from
    there, even once the plan cache has evicted it; outside, nothing is held."""
    held = {}
    with lwe.keeping(held):
        plan = lwe.plan_tensor(np.array([2, 0, 1]), "cpu")
        const = gates.CONSTANT(np.array([1, 0, 1]), 8, (3,), device="cpu")
        assert lwe.plan_tensor(np.array([2, 0, 1]), "cpu") is plan
    assert len(held) == 2 and any(t is plan for t in held.values())
    assert torch.equal(const.b, torch.tensor([gates.MU, -gates.MU, gates.MU], dtype=torch.int32))
    lwe._plan_tensor.cache_clear()
    with lwe.keeping(held):
        assert lwe.plan_tensor(np.array([2, 0, 1]), "cpu") is plan
    assert lwe.plan_tensor(np.array([2, 0, 1]), "cpu") is not plan
    lwe.plan_tensor(np.array([7, 7]), "cpu")
    assert len(held) == 2                       # nothing is held outside the context


def test_capture_reads_the_warm_ups_plans(graphs):
    """A plan the warm-up put on the device and the cache evicted before the
    capture reaches the capture from the key's own dict: the capture reads
    the very tensor of the warm-up and copies nothing from the host (on the
    card such a copy cannot be captured)."""
    seen = []

    @arith.circuit
    def gather(x, cloud):
        seen.append(lwe.plan_tensor(np.array([1, 0, 3, 2]), x.device))
        return LweCiphertext(x.a + 1, x.b[..., seen[-1]], x.cv)

    class Capturing(Recording):
        def capture(self, run):
            out = super().capture(run)
            self.misses = lwe._plan_tensor.cache_info().misses
            return out

    graphs.graph = Capturing
    cloud, x = object(), _random_ct(1)
    gather(x, cloud)                                          # the warm-up
    lwe._plan_tensor.cache_clear()
    misses = lwe._plan_tensor.cache_info().misses
    out = gather(x, cloud)                                    # captures
    assert Recording.log[0] == "capture" and seen[1] is seen[0]
    entry = next(iter(graphs.entries.values()))
    assert entry.graph.misses == misses
    assert [t for t in entry.held.values()] == [seen[0]]
    assert torch.equal(out.b, x.b[..., [1, 0, 3, 2]])


def test_default_captures_after_capture_after_calls(monkeypatch):
    """By default a key runs eagerly CAPTURE_AFTER times, the first the
    warm-up, and the next call captures; counts tallies the calls."""
    Recording.log = []
    g = arith.CircuitGraphs(Recording)
    assert g.eager_calls == arith.CAPTURE_AFTER >= 1
    monkeypatch.setattr(arith, "GRAPHS", g)
    bump, runs = _bump_circuit()
    cloud, x = object(), _random_ct(1)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        for _ in range(arith.CAPTURE_AFTER):
            bump(x, cloud)
        assert Recording.log == [] and g.graphs() == 0 and len(runs) == arith.CAPTURE_AFTER
        bump(x, cloud)
        bump(x, cloud)
        monkeypatch.setattr(arith, "CAPTURE_MAX_BATCH", 1)
        bump(x, cloud)
    assert Recording.log == ["capture", "replay", "replay"] and g.graphs() == 1
    assert g.counts == {"first": 1, "eager": arith.CAPTURE_AFTER - 1, "capture": 1, "replay": 1,
                        "over_rule": 1}


# ------------------------------------------------------------------ against tfhe_tpu

CASES = {
    "add": (lambda m, a, b, c: m.add(a, b, c), lambda a, b: a + b),
    "mul_plain": (lambda m, a, b, c: m.mul_plain(a, 3, c), lambda a, b: 3 * a),
    "div": (lambda m, a, b, c: m.div(a, b, c), lambda a, b: np.trunc(a / b).astype(np.int64)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_captured_circuit_matches_tfhe_tpu_jit(graphs, toy, name):
    """The second call (capture, replay) and the third (replay on other
    operands) equal tfhe_tpu's jitted circuit on the same operands."""
    jsk, psk, vals, cts = toy
    call, truth = CASES[name]
    with jconfig.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        want = [call(ja, ca, cb, jsk.cloud) for ca, cb in cts]
    port = [(_ct(ca), _ct(cb)) for ca, cb in cts]
    call(arith, *port[0], psk.cloud)                          # the warm-up
    got = [call(arith, *p, psk.cloud) for p in port]
    assert Recording.log == ["capture", "replay", "replay"]
    for g, w, (a, b) in zip(got, want, vals):
        _assert_same(g, w)
        v = truth(a, b) & (2 ** NB - 1)
        np.testing.assert_array_equal(arith.decrypt_int(psk, g), np.where(v >> (NB - 1), v - 2 ** NB, v))
