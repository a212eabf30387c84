"""The port's integer circuits at a gadget of three levels against tfhe_tpu
on the CPU.

PARAMS_TOY with PARAMS_128's gadget (PARAMS_TOY_L3: l = 3, Bg = 2^7) in both
packages, on the same seeded raw keys (tfhe_tpu's keygen) and the same
4-bit operands (tfhe_tpu's encryption):

- arith's add, sub, mul, gt, eq, absolute, minimum and div on the ripple arm
  (the CPU's own) and on the parallel-prefix arm's Kogge-Stone network
  (TFHE_TPU_LOOKAHEAD=1 in both packages), word for word: a and b exact, cv
  to rtol 1e-6; every answer also against integer semantics;
- the same circuits on the Sklansky network, the prefix arm the card takes
  (``arith._prefix_network``), which tfhe_tpu does not have: against
  integer semantics;
- CipherInt's operators, word for word;
- the paired bootstrap (``core.bootstrap.bootstrap_paired``) under
  ``gates.MUX`` and ``gates.prefix_combine``, on the fused route's plain
  versions (TFHE_TPU_FUSEKS=1: the key switch sums the pairs) and on the
  split route (=0), each word for word against tfhe_tpu's gate.
"""
import dataclasses

import numpy as np
import pytest

import tfhe_tpu as jt
from tfhe_tpu import arith as ja
from tfhe_tpu import config as jconfig
from tfhe_tpu import gates as jg
from tfhe_tpu.cipher import CipherInt as JCipherInt
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import CipherInt, arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.utils import profiling
from torch_parity import assert_same, port_keys, to_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

J_TOY_L3 = dataclasses.replace(jt.PARAMS_TOY, bk_l=3, bk_Bgbit=7)
NB = 4
A = np.array([3, 7, -8, -3], np.int64)
B = np.array([2, -1, 3, 6], np.int64)


def _signed(v):
    v = np.asarray(v, np.int64) & ((1 << NB) - 1)
    return np.where(v >> (NB - 1), v - (1 << NB), v)


@pytest.fixture(scope="module")
def toy_l3():
    """tfhe_tpu's keys at the toy l = 3 set, the port's from the same raw keys,
    and the operands encrypted by tfhe_tpu: a, b signed, pa, pb positive."""
    jsk = jt.keygen(J_TOY_L3, seed=(161, 803, 398))
    vals = {"a": A, "b": B, "pa": np.abs(A) & 7, "pb": np.abs(B) & 7}
    cts = {k: ja.encrypt_int(jsk, v, NB, seed=90 + i) for i, (k, v) in enumerate(vals.items())}
    return jsk, port_keys(jsk, pt.PARAMS_TOY_L3), vals, cts


# name -> (operands, plaintext answer)
CIRCUITS = {
    "add": ("ab", lambda a, b: a + b),
    "sub": ("ab", lambda a, b: a - b),
    "mul": ("ab", lambda a, b: a * b),
    "gt": ("ab", lambda a, b: (a > b).astype(np.int64)),
    "eq": ("ab", lambda a, b: (a == b).astype(np.int64)),
    "absolute": ("a", lambda a: np.abs(a)),
    "minimum": (("pa", "pb"), lambda a, b: np.minimum(a, b)),
    "div": ("ab", lambda a, b: np.trunc(a / b).astype(np.int64)),
}
ARMS = {"ripple": "0", "kogge_stone": "1"}


def _check_plaintext(psk, name: str, got, want) -> None:
    if name in ("gt", "eq"):                     # one bit a number
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), want)
    else:
        np.testing.assert_array_equal(arith.decrypt_int(psk, got), _signed(want))


@pytest.mark.parametrize("name", list(CIRCUITS))
@pytest.mark.parametrize("arm", list(ARMS))
def test_circuit_at_three_levels_matches_tfhe_tpu(toy_l3, arm, name):
    jsk, psk, vals, cts = toy_l3
    ops, truth = CIRCUITS[name]
    with jconfig.overrides(TFHE_TPU_LOOKAHEAD=ARMS[arm]):
        want = getattr(ja, name)(*[cts[o] for o in ops], jsk.cloud)
    with config.overrides(TFHE_TPU_LOOKAHEAD=ARMS[arm]):
        got = getattr(arith, name)(*[to_torch(cts[o]) for o in ops], psk.cloud)
    assert_same(got, want)
    _check_plaintext(psk, name, got, truth(*[vals[o] for o in ops]))


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_at_three_levels_on_sklansky(toy_l3, monkeypatch, name):
    """The prefix arm on the card's Sklansky network, decrypted; the adders
    count their carry chains under it."""
    jsk, psk, vals, cts = toy_l3
    ops, truth = CIRCUITS[name]
    monkeypatch.setattr(arith, "_prefix_network", lambda device: "sklansky")
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
        got = getattr(arith, name)(*[to_torch(cts[o]) for o in ops], psk.cloud)
    _check_plaintext(psk, name, got, truth(*[vals[o] for o in ops]))
    if name in ("add", "sub"):
        assert arith.PREFIX_NETWORKS == {"kogge_stone": 0, "sklansky": 1}


OPS = {
    "+": lambda x, y: x + y, "-": lambda x, y: x - y, "*": lambda x, y: x * y,
    "/": lambda x, y: x / y, ">": lambda x, y: x > y, "eq": lambda x, y: x.eq(y),
    "abs": lambda x, y: x.abs(), "minimum": lambda x, y: x.minimum(y),
}


@pytest.mark.parametrize("op", list(OPS))
def test_cipher_int_at_three_levels_matches_tfhe_tpu(toy_l3, op):
    jsk, psk, vals, cts = toy_l3
    names = ("pa", "pb") if op == "minimum" else ("a", "b")
    want = OPS[op](*(JCipherInt(cts[k], jsk.cloud) for k in names))
    got = OPS[op](*(CipherInt(to_torch(cts[k]), psk.cloud) for k in names))
    assert_same(got.ct if isinstance(got, CipherInt) else got,
                want.ct if isinstance(want, JCipherInt) else want)


def _gate(mod, kind, cts, cloud):
    """The gate of `mod` (either package's gates) on the toy bits."""
    if kind == "mux":
        return (mod.MUX(cts[0], cts[1], cts[2], cloud),)
    return tuple(mod.prefix_combine(*cts, cloud))


@pytest.mark.parametrize("size", [1, 7])
@pytest.mark.parametrize("route", ["kernel", "split"])
@pytest.mark.parametrize("kind", ["mux", "prefix"])
def test_paired_bootstrap_at_three_levels_matches_tfhe_tpu(toy_l3, kind, route, size):
    """The port's paired route of the gate (``PAIR_KS`` names the one that
    ran) against tfhe_tpu's gate on the same encryptions, and the plaintext."""
    jsk, psk, _, _ = toy_l3
    rng = np.random.RandomState(size)
    bits = rng.randint(0, 2, size=(4, size))
    jcts = [jt.encrypt_bits(jsk, b, seed=70 + size + i) for i, b in enumerate(bits)]
    want = _gate(jg, kind, jcts, jsk.cloud)
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_FUSEKS="1" if route == "kernel" else "0"):
        got = _gate(gates, kind, [to_torch(c) for c in jcts], psk.cloud)
    assert bs.PAIR_KS == {"kernel": 0, "split": 0} | {route: 1}
    for g, w in zip(got, want, strict=True):
        assert_same(g, w)
    truth = ((np.where(bits[0] == 1, bits[1], bits[2]),) if kind == "mux" else
             (np.where(bits[2] == 1, bits[1], bits[0]), bits[2] & bits[3]))
    for g, t in zip(got, truth, strict=True):
        np.testing.assert_array_equal(pt.decrypt_bits(psk, g), t)
