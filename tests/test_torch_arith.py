"""tfhe_tpu_torch.arith against tfhe_tpu.arith and plain integer semantics.

Every circuit of tests/test_arith.py at PARAMS_TOY on 4-bit operands, plus
the ones that file does not call (add_fast, mul_full, mul_karatsuba, dot,
add_sign, the row reductions): the same JAX-encrypted inputs go through both
packages, and the port's a and b must equal tfhe_tpu's exactly, cv to rtol
1e-6. Its two real-noise tests run on the port's own keys against plain
integers. The prefix and septet arms are in test_torch_arith_arms.py. A slow
test recomputes the PARAMS_110 add16 golden that chip_smoke.py holds the
card against."""
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import arith as ja
from tfhe_tpu import ref_keygen as j_ref_keygen
from tfhe_tpu.core.keys import keygen_reference as j_keygen_reference
from tfhe_tpu.core.lwe import LweCiphertext as JLwe
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, ref_keygen
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 4
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_add16_golden.json")


def _signed(v, nbits=NB):
    v = np.asarray(v, np.int64) & ((1 << nbits) - 1)
    return np.where(v >> (nbits - 1), v - (1 << nbits), v)


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def _assert_same(got: LweCiphertext, want) -> None:
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def toy(toy_keys):
    """JAX toy keys, the port's key set from the same raw keys, and 4-bit
    operands encrypted by tfhe_tpu: a, b signed, p positive."""
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    a = np.array([3, 7, -8, 5, -3], np.int64)
    b = np.array([2, 1, 3, -5, 6], np.int64)
    p = np.abs(a) & 7
    cts = {k: ja.encrypt_int(toy_keys, v, NB, seed=s) for k, v, s in
           (("a", a, 21), ("b", b, 22), ("p", p, 23))}
    return toy_keys, psk, {"a": a, "b": b, "p": p}, cts


# name -> (operands, plaintext answer, signed result)
CIRCUITS = {
    "add": ("ab", lambda a, b: a + b),
    "add_fast": ("ab", lambda a, b: a + b),
    "add_numberwise": ("ab", lambda a, b: a + b),
    "sub": ("ab", lambda a, b: a - b),
    "twos_complement": ("a", lambda a: -a),
    "mul": ("ab", lambda a, b: a * b),
    "mul_mux": ("ab", lambda a, b: a * b),
    "mul_karatsuba": ("ab", lambda a, b: a * b),
    "absolute": ("a", lambda a: np.abs(a)),
    "minimum": ("pb", lambda p, b: np.minimum(p, b & 7)),
    "gt": ("ab", lambda a, b: (a > b).astype(np.int64)),
    "le": ("ab", lambda a, b: (a <= b).astype(np.int64)),
    "eq": ("ab", lambda a, b: (a == b).astype(np.int64)),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_matches_tfhe_tpu(toy, name):
    jsk, psk, vals, cts = toy
    ops, truth = CIRCUITS[name]
    if name == "minimum":                      # positive operands (arith.py:864)
        cts = dict(cts, b=ja.encrypt_int(jsk, vals["b"] & 7, NB, seed=24))
    jargs = [cts[o] for o in ops]
    want = getattr(ja, name)(*jargs, jsk.cloud)
    got = getattr(arith, name)(*[_ct(c) for c in jargs], psk.cloud)
    _assert_same(got, want)
    expect = truth(*[vals[o] for o in ops])
    if got.batch_shape[-1:] == (NB,):
        np.testing.assert_array_equal(arith.decrypt_int(psk, got), _signed(expect))
    else:
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), expect)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 7])
def test_mul_plain(toy, k):
    jsk, psk, vals, cts = toy
    want = ja.mul_plain(cts["a"], k, jsk.cloud)
    got = arith.mul_plain(_ct(cts["a"]), k, psk.cloud)
    _assert_same(got, want)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got), _signed(vals["a"] * k))


def test_mul_full_and_dot(toy):
    """mul_full at 6 output bits, and the fused dot product over a K = 2 axis."""
    jsk, psk, vals, cts = toy
    want = ja.mul_full(cts["p"], cts["p"], jsk.cloud, 6)
    got = arith.mul_full(_ct(cts["p"]), _ct(cts["p"]), psk.cloud, 6)
    _assert_same(got, want)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got, signed=False), vals["p"] ** 2)
    a2, b2 = cts["a"][:4].reshape(2, 2, NB), cts["b"][:4].reshape(2, 2, NB)
    want = ja.dot(a2, b2, jsk.cloud)
    got = arith.dot(_ct(a2), _ct(b2), psk.cloud)
    _assert_same(got, want)
    prod = (vals["a"][:4] * vals["b"][:4]).reshape(2, 2).sum(-1)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got), _signed(prod))


def test_row_reductions(toy):
    """The carry-save row reduction and the reference-shaped pairwise tree
    over 3 rows of 4-bit numbers (two sums in the batch)."""
    jsk, psk, vals, cts = toy
    rows = ja.encrypt_int(jsk, np.array([[3, -2, 5], [7, 1, -4]]), NB, seed=26)
    for want, got in ((ja._csa_reduce_rows(rows, jsk.cloud),
                       arith._csa_reduce_rows(_ct(rows), psk.cloud)),
                      (ja._tree_sum_rows(rows, ja.add, jsk.cloud),
                       arith._tree_sum_rows(_ct(rows), arith.add, psk.cloud))):
        _assert_same(got, want)
        np.testing.assert_array_equal(arith.decrypt_int(psk, got), [6, 4])


def test_add_sign(toy):
    jsk, psk, vals, cts = toy
    sign = jt.encrypt_bits(jsk, np.array([1, 0, 1, 0, 1]), seed=25)
    want = ja.add_sign(cts["a"], sign, jsk.cloud)
    got = arith.add_sign(_ct(cts["a"]), _ct(sign), psk.cloud)
    _assert_same(got, want)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got),
                                  _signed(np.where([1, 0, 1, 0, 1], -vals["a"], vals["a"])))


def test_shifts(toy):
    """left_shift, the bootstrap-free arithmetic right shift, and the right
    shift with the reference's negative-rounding correction."""
    jsk, psk, vals, cts = toy
    a, ca = vals["a"], cts["a"]
    for want, got, expect in (
            (ja.left_shift(ca, 1), arith.left_shift(_ct(ca), 1), _signed(a << 1)),
            (ja.right_shift_arith(ca, 1), arith.right_shift_arith(_ct(ca), 1), a >> 1),
            (ja.right_shift_arith(ca, 1, jsk.cloud),
             arith.right_shift_arith(_ct(ca), 1, psk.cloud), (a >> 1) + (a < 0))):
        _assert_same(got, want)
        np.testing.assert_array_equal(arith.decrypt_int(psk, got), expect)


def test_div_matches_tfhe_tpu(toy):
    """Division byte-equal to tfhe_tpu, on two of the operand pairs."""
    jsk, psk, vals, cts = toy
    want = ja.div(cts["a"][:2], cts["b"][:2], jsk.cloud)
    got = arith.div(_ct(cts["a"][:2]), _ct(cts["b"][:2]), psk.cloud)
    _assert_same(got, want)


def test_div_plaintext(toy):
    """The port's division against truncating integer division."""
    jsk, psk, vals, cts = toy
    got = arith.div(_ct(cts["a"]), _ct(cts["b"]), psk.cloud)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got),
                                  _signed(np.trunc(vals["a"] / vals["b"]).astype(np.int64)))


def test_encrypt_int_and_trivial_bits():
    """The port's own keys and torch.Generator encryption round-trip
    integers; trivial_bits decrypts to its constant."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    v = np.array([[-8, 7], [0, -1]])
    ct = arith.encrypt_int(sk, v, NB, gen, "cpu")
    assert ct.batch_shape == (2, 2, NB)
    np.testing.assert_array_equal(arith.decrypt_int(sk, ct), v)
    bits = arith.trivial_bits([1, 0, 1], sk.params.n, (2, 3), device="cpu")
    np.testing.assert_array_equal(pt.decrypt_bits(sk, bits), [[1, 0, 1]] * 2)
    assert arith.circuit(arith.add.__wrapped__).__wrapped__ is arith.add.__wrapped__


def test_add_chain_under_real_noise():
    """A 7-stage carry chain at PARAMS_SMALL_NOISY (the reference's noise
    levels) on the port's own keys decrypts to the sum."""
    sk = pt.keygen(pt.PARAMS_SMALL_NOISY, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    rng = np.random.RandomState(3)
    a, b = rng.randint(0, 1 << 6, size=4), rng.randint(0, 1 << 6, size=4)
    out = arith.add(arith.encrypt_int(sk, a, 8, gen, "cpu"),
                    arith.encrypt_int(sk, b, 8, gen, "cpu"), sk.cloud)
    np.testing.assert_array_equal(arith.decrypt_int(sk, out, signed=False), a + b)


def test_mul16_under_real_noise():
    """A 16-bit multiply (136 partial products through the carry-save tree)
    at PARAMS_SMALL_NOISY on the port's own keys decrypts to the product."""
    sk = pt.keygen(pt.PARAMS_SMALL_NOISY, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(8)
    rng = np.random.RandomState(5)
    a, b = rng.randint(0, 1 << 7, size=2), rng.randint(0, 1 << 7, size=2)
    out = arith.mul(arith.encrypt_int(sk, a, 16, gen, "cpu"),
                    arith.encrypt_int(sk, b, 16, gen, "cpu"), sk.cloud)
    np.testing.assert_array_equal(arith.decrypt_int(sk, out, signed=False), a * b)


def _add16_inputs(g, lwe_key, ref):
    """The golden's reference-encrypted operands (fixture 'inputs')."""
    ref.keygen_raw(tuple(g["seed"]))
    a, b = ref.encrypt_bits(lwe_key, g["a_bits"] + g["b_bits"])
    nb, z = g["nbits"], np.zeros(g["nbits"], np.float32)
    return (a[:nb], b[:nb], z), (a[nb:], b[nb:], z)


@pytest.mark.slow
def test_add16_golden():
    """Recompute tests/fixtures/torch_port_add16_golden.json with tfhe_tpu on
    the CPU, and the port's plain path reproduces it."""
    with open(GOLDEN) as f:
        g = json.load(f)
    jsk = j_keygen_reference(jt.PARAMS_110, seed=tuple(g["seed"]))
    x, y = _add16_inputs(g, jsk.lwe_key, j_ref_keygen)
    want = ja.add(JLwe(*map(jnp.asarray, x)), JLwe(*map(jnp.asarray, y)), jsk.cloud)
    sha = hashlib.sha256(np.asarray(want.a).astype("<i4").tobytes()
                         + np.asarray(want.b).astype("<i4").tobytes()).hexdigest()
    assert sha == g["sha256"]
    assert int(ja.decrypt_int(jsk, want)) == g["sum"]
    psk = pt.keygen_reference(pt.PARAMS_110, seed=tuple(g["seed"]), device="cpu")
    x, y = _add16_inputs(g, psk.lwe_key, ref_keygen)
    got = arith.add(LweCiphertext(*map(torch.from_numpy, x)),
                    LweCiphertext(*map(torch.from_numpy, y)), psk.cloud)
    _assert_same(got, want)
