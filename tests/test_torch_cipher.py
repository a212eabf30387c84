"""tfhe_tpu_torch.CipherInt against tfhe_tpu.cipher.CipherInt: every operator
on the same JAX-encrypted 4-bit operands at PARAMS_TOY, a and b exact, cv to
rtol 1e-6, and the decrypted values against plain integer semantics."""
import numpy as np
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu.cipher import CipherInt as JCipherInt
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import CipherInt
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 4


def _signed(v):
    v = np.asarray(v, np.int64) & ((1 << NB) - 1)
    return np.where(v >> (NB - 1), v - (1 << NB), v)


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def _assert_same(got, want) -> None:
    got = got.ct if isinstance(got, CipherInt) else got
    want = want.ct if isinstance(want, JCipherInt) else want
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def pair(toy_keys):
    """JAX and port CipherInts on the same encryptions of x, y (signed) and
    the positive px, py."""
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    vals = {"x": np.array([5, -3]), "y": np.array([-3, 2]),
            "px": np.array([5, 3]), "py": np.array([6, 2])}
    j = {k: JCipherInt.encrypt(toy_keys, v, NB, seed=41 + i) for i, (k, v) in enumerate(vals.items())}
    p = {k: CipherInt(_ct(c.ct), psk.cloud) for k, c in j.items()}
    return toy_keys, psk, vals, j, p


OPS = {
    "+": (lambda x, y, px, py: x + y, lambda x, y: x + y),
    "-": (lambda x, y, px, py: x - y, lambda x, y: x - y),
    "*": (lambda x, y, px, py: x * y, lambda x, y: x * y),
    "neg": (lambda x, y, px, py: -x, lambda x, y: -x),
    "<<": (lambda x, y, px, py: x << 1, lambda x, y: x << 1),
    ">>": (lambda x, y, px, py: x >> 1, lambda x, y: (x >> 1) + (x < 0)),
    "abs": (lambda x, y, px, py: x.abs(), lambda x, y: np.abs(x)),
    "minimum": (lambda x, y, px, py: px.minimum(py), lambda x, y: np.minimum([5, 3], [6, 2])),
    "increment": (lambda x, y, px, py: x.increment(), lambda x, y: x + 1),
    ">": (lambda x, y, px, py: x > y, lambda x, y: (x > y).astype(np.int64)),
    "<=": (lambda x, y, px, py: x <= y, lambda x, y: (x <= y).astype(np.int64)),
    "eq": (lambda x, y, px, py: x.eq(y), lambda x, y: (x == y).astype(np.int64)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_operator_matches_tfhe_tpu(pair, op):
    jsk, psk, vals, j, p = pair
    call, truth = OPS[op]
    want = call(j["x"], j["y"], j["px"], j["py"])
    got = call(p["x"], p["y"], p["px"], p["py"])
    _assert_same(got, want)
    expect = truth(vals["x"], vals["y"])
    if isinstance(got, CipherInt):
        assert got.nbits == NB and got.batch_shape == (2,)
        np.testing.assert_array_equal(got.decrypt(psk), _signed(expect))
    else:
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), expect)


def test_division_and_in_place_operators(pair):
    """/ (and //) against truncating division on the port; += and -= as in
    tfhe_tpu's test_cipher_increment_iadd."""
    jsk, psk, vals, j, p = pair
    q = p["x"] / p["y"]
    np.testing.assert_array_equal(q.decrypt(psk), np.trunc(vals["x"] / vals["y"]).astype(int))
    x = p["x"]
    x += p["y"]
    np.testing.assert_array_equal(x.decrypt(psk), _signed(vals["x"] + vals["y"]))
    x -= p["y"]
    np.testing.assert_array_equal(x.decrypt(psk), vals["x"])


def test_trivial_and_encrypt_on_the_key_device(pair):
    """trivial builds on the cloud key's device and matches tfhe_tpu's;
    encrypt takes a torch.Generator and a device."""
    jsk, psk, vals, j, p = pair
    t = CipherInt.trivial(np.array([3, -2]), NB, psk.cloud)
    assert t.ct.b.device == psk.cloud.bk_ntt.device
    _assert_same(t, JCipherInt.trivial(np.array([3, -2]), NB, jsk.cloud))
    c = CipherInt.encrypt(psk, np.array([-7, 6]), NB, torch.Generator().manual_seed(1), "cpu")
    np.testing.assert_array_equal(c.decrypt(psk), [-7, 6])
    np.testing.assert_array_equal(c.decrypt(psk, signed=False), [9, 6])
