"""The Sklansky carry network of the adders' prefix arm (``arith.add_fast``,
``arith.sub``), held on the CPU. On the card, where the card's cost picks
the prefix arm, the adders run Sklansky over the nbits - 1 carries the sum
reads (``arith._prefix_network``); under TFHE_TPU_LOOKAHEAD=1 and on the CPU
they keep Kogge-Stone, ``tfhe_tpu``'s prefix arm, which
tests/test_torch_arith_arms.py holds word for word. Here: the network's plan
in a plaintext simulation at 4-32 bits, the stage widths it sends against
what the cost model prices (a stand-in bootstrap records them), the
circuits on the network at PARAMS_TOY decrypted against integer semantics,
the counter ``PREFIX_NETWORKS`` through eager calls and graph replays, and
the network as a function of a captured circuit's key."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 8
IN_FLIGHT = 30          # samples an H100 holds at once in K5's clusters of four, N = 1024


@pytest.fixture
def sklansky(monkeypatch):
    """The prefix arm on the Sklansky network on the CPU: the arm forced by
    TFHE_TPU_LOOKAHEAD=1, the network the card's own (``_prefix_network``)."""
    monkeypatch.setattr(arith, "_prefix_network", lambda device: "sklansky")
    with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
        yield


# ------------------------------------------------------------ the plan, in plaintext

def _simulate(a, b, nbits: int, subtract: bool):
    """a + b (or a - b) mod 2^nbits on plaintext bit arrays through the
    Sklansky plan: (g, p) over bits 0..nbits-2 (for a subtraction g_0 folds
    in the carry-in, a | ~b), the levels of ``_sklansky_levels``, the sums
    with the top bit as a 3-way XOR. Returns the integers."""
    bits = lambda v: (v[:, None] >> np.arange(nbits)) & 1
    x, y = bits(a), bits(b)
    if subtract:
        y = 1 - y
    m = nbits - 1
    g, p = x[:, :m] & y[:, :m], x[:, :m] ^ y[:, :m]
    if subtract:
        g[:, 0] = x[:, 0] | y[:, 0]
    c, pc = g.copy(), p.copy()
    for hi, lo in arith._sklansky_levels(m):
        c[:, hi], pc[:, hi] = c[:, hi] | (pc[:, hi] & c[:, lo]), pc[:, hi] & pc[:, lo]
    s = np.empty_like(x)
    s[:, 0] = p[:, 0] ^ subtract
    s[:, 1:m] = p[:, 1:] ^ c[:, :m - 1]
    s[:, m] = x[:, m] ^ y[:, m] ^ c[:, m - 1]
    return np.sum(s.astype(object) << np.arange(nbits), axis=1)


@pytest.mark.parametrize("nbits", [4, 8, 16, 32])
@pytest.mark.parametrize("subtract", [False, True], ids=["add", "sub"])
def test_the_plan_computes_every_carry(nbits, subtract):
    """Every level combines the upper half of each block with the top of its
    lower half, so after the last level position i holds the carry out of
    bits 0..i: the sums equal integer arithmetic mod 2^nbits on random and
    edge operands (0, 1, all ones, the top bit alone, long carry runs)."""
    mask = (1 << nbits) - 1
    rng = np.random.RandomState(nbits)
    edge = [0, 1, mask, 1 << (nbits - 1), mask >> 1, mask - 1, 0x5555_5555 & mask,
            0xAAAA_AAAA & mask]
    a = np.array(edge * len(edge) + [int(v) for v in rng.randint(0, 1 << 62, 256) & mask],
                 dtype=object)
    b = np.array([e for e in edge for _ in edge] + [int(v) for v in
                  rng.randint(0, 1 << 62, 256) & mask], dtype=object)
    got = _simulate(a.astype(np.int64), b.astype(np.int64), nbits, subtract)
    want = [((x - y) if subtract else (x + y)) & mask for x, y in zip(a, b)]
    assert list(got) == want


@pytest.mark.parametrize("m", [1, 2, 3, 7, 15, 31])
def test_levels_are_log_depth_and_at_most_half_wide(m):
    """ceil(log2 m) levels of at most ceil(m / 2) combines, each reading a
    position its level does not write."""
    levels = arith._sklansky_levels(m)
    assert len(levels) == (m - 1).bit_length()
    for hi, lo in levels:
        assert hi.size <= -(-m // 2) and not set(lo) & set(hi) and lo.min() >= 0


# ------------------------------------------------------------ the stages it sends

@pytest.fixture
def widths(monkeypatch):
    """A stand-in bootstrap that records each flat batch (a paired one with
    its pairs) and returns samples of the right shapes: no cryptography runs."""
    seen = []

    def bootstrap(x, mu, cloud):
        seen.append(x.b.shape[0])
        return x

    def paired(x, mu, cloud, pairs, b_add):
        seen.append(x.b.shape[0])
        return x[pairs:]

    monkeypatch.setattr(bs, "bootstrap", bootstrap)
    monkeypatch.setattr(bs, "bootstrap_paired", paired)
    return seen


def _zeros(shape, n=16):
    return LweCiphertext(torch.zeros(shape + (n,), dtype=torch.int32),
                         torch.zeros(shape, dtype=torch.int32),
                         torch.zeros(shape, dtype=torch.float32))


@pytest.mark.parametrize("numbers,nbits", [(1, 16), (1, 8), (4, 16), (1, 32)])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_stage_widths_are_what_the_cost_model_prices(sklansky, widths, op, numbers, nbits):
    """add and sub on the network send, stage by stage, the flat batches
    ``adder_stages(numbers, nbits, "sklansky")`` prices; a one-number 16-bit
    add or sub sends none over the 30 samples K5 holds in clusters of four,
    and 122 samples where Kogge-Stone sends 194."""
    cloud = SimpleNamespace(params=pt.PARAMS_TOY)
    x = _zeros((numbers, nbits))
    getattr(arith, op)(x, x, cloud)
    assert widths == arith.adder_stages(numbers, nbits, "sklansky")[1]
    if (numbers, nbits) == (1, 16):
        assert widths == [30, 21, 21, 21, 14, 15] and max(widths) <= IN_FLIGHT
        assert sum(widths) == 122 and sum(arith.adder_stages(1, 16)[1]) == 194
        assert arith.adder_stages(4, 4, "sklansky")[1] == [4 * w for w in (6, 3, 2, 3)]


def test_kogge_stone_stages_are_unchanged(widths):
    """Under TFHE_TPU_LOOKAHEAD=1 the adders keep Kogge-Stone on every
    device, the widths ``adder_stages`` prices by default; sub's g_0 is a
    stage of its own there."""
    cloud = SimpleNamespace(params=pt.PARAMS_TOY)
    x = _zeros((1, 16))
    with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
        for device in ("cpu", "cuda"):
            assert arith._prefix_network(device) == "kogge_stone"
        arith.add(x, x, cloud)
        assert widths == arith.adder_stages(1, 16)[1] == [32, 45, 42, 36, 24, 15]
        widths.clear()
        arith.sub(x, x, cloud)
        assert widths == [32, 1, 45, 42, 36, 24, 15]


# ------------------------------------------------------------ the circuits, decrypted

def _signed(v):
    v = np.asarray(v, np.int64) & ((1 << NB) - 1)
    return np.where(v >> (NB - 1), v - (1 << NB), v)


@pytest.fixture(scope="module")
def toy8():
    sk = pt.keygen(pt.PARAMS_TOY, seed=(18, 2, 3), device="cpu")
    a = np.array([37, -61, 0, -128, 127], np.int64)
    b = np.array([-41, 23, -1, 127, -128], np.int64)
    gen = torch.Generator().manual_seed(18)
    return sk, a, b, [arith.encrypt_int(sk, v, NB, gen, "cpu") for v in (a, b)]


CIRCUITS = {
    "add": (lambda x, y, c: arith.add(x, y, c), lambda a, b: a + b, 1),
    "sub": (lambda x, y, c: arith.sub(x, y, c), lambda a, b: a - b, 1),
    "absolute": (lambda x, y, c: arith.absolute(x, c), lambda a, b: np.abs(a), 1),
    "mul": (lambda x, y, c: arith.mul(x, y, c), lambda a, b: a * b, 1),
    "div": (lambda x, y, c: arith.div(x, y, c),
            lambda a, b: np.trunc(a / b).astype(np.int64), NB + 2),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuits_on_the_network_decrypt_right(toy8, sklansky, name):
    """add, sub, absolute, mul and div at PARAMS_TOY on 8-bit operands, every
    adder on the Sklansky network: the integer answers mod 2^8, and one
    Sklansky chain an adder (div: two absolutes and one add a quotient bit)."""
    sk, a, b, (x, y) = toy8
    call, truth, chains = CIRCUITS[name]
    before = dict(arith.PREFIX_NETWORKS)
    out = call(x, y, sk.cloud)
    np.testing.assert_array_equal(arith.decrypt_int(sk, out), _signed(truth(a, b)))
    assert {k: arith.PREFIX_NETWORKS[k] - v for k, v in before.items()} == {
        "kogge_stone": 0, "sklansky": chains}


# ------------------------------------------------------------ counted, and keyed

class Recording:
    """Stand-in for ``arith.CudaGraph`` on CPU tensors: capture runs the
    circuit once, replay runs it again on the graph's inputs into its
    outputs, and neither leaves a count in the registered counters (the
    graph's are counted by ``CircuitGraphs``)."""
    device_type = "cpu"

    def __init__(self, device):
        self.pool_bytes = 0

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        saved = profiling.snapshot()
        new = self.run()
        profiling.counts_since(saved)
        for f in ("a", "b", "cv"):
            getattr(self.out, f).copy_(getattr(new, f))


def test_replays_add_the_chains_of_their_capture(toy8, sklansky, monkeypatch):
    """One count a chain in every mode: the eager warm-up, the capture (whose
    own run counts nothing; its first replay counts), each replay; the
    graph keeps one Sklansky chain, and replays equal the eager result."""
    sk, a, b, (x, y) = toy8
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(Recording, eager_calls=1))
    before = dict(arith.PREFIX_NETWORKS)
    outs = []
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        for _ in range(4):
            outs.append(arith.add(x, y, sk.cloud))
            assert arith.PREFIX_NETWORKS["kogge_stone"] == before["kogge_stone"]
            outs[-1] = (outs[-1], arith.PREFIX_NETWORKS["sklansky"] - before["sklansky"])
    assert [n for _, n in outs] == [1, 2, 3, 4]
    assert arith.GRAPHS.counts["capture"] == 1 and arith.GRAPHS.counts["replay"] == 2
    entry = next(iter(arith.GRAPHS.entries.values()))
    assert entry.counted["prefix_networks"] == {"sklansky": 1}
    for out, _ in outs[1:]:
        for f in ("a", "b", "cv"):
            assert torch.equal(getattr(out, f), getattr(outs[0][0], f)), f
    profiling.reset_counters()
    assert arith.PREFIX_NETWORKS == {"kogge_stone": 0, "sklansky": 0}


def test_the_network_is_a_function_of_the_circuit_key():
    """The network follows TFHE_TPU_LOOKAHEAD and the device type, and a
    captured circuit's key (``circuit_key``) holds both: the flag in its
    policy, the device of every tensor of each ciphertext argument in its
    parts. So a graph captured under one network is never replayed under
    the other. On CUDA auto is Sklansky and the forced arm Kogge-Stone; the
    CPU is Kogge-Stone whatever the flag."""
    args = (_zeros((1, NB)), _zeros((1, NB)), SimpleNamespace())
    keys, networks = {}, {}
    for v in ("auto", "0", "1"):
        with config.overrides(TFHE_TPU_LOOKAHEAD=v):
            key, _ = arith.circuit_key(arith.add, args, frozenset(), torch.device("cpu"))
            networks[v] = {d: arith._prefix_network(d) for d in ("cuda", "cuda:1", "cpu")}
        assert key[1][0] == v
        assert all(t[0] == "cpu" for part in key[2][:2] for t in part)
        keys[v] = key
    assert len(set(keys.values())) == 3
    assert networks["auto"] == {"cuda": "sklansky", "cuda:1": "sklansky", "cpu": "kogge_stone"}
    assert networks["0"] == networks["1"] == {d: "kogge_stone" for d in ("cuda", "cuda:1", "cpu")}
