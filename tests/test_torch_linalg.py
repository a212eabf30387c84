"""tfhe_tpu_torch.linalg and apps.linreg against tfhe_tpu and plain integers.

The cases of tests/test_linalg.py and of the linear regressions in
tests/test_apps.py at PARAMS_TOY: the same JAX-encrypted inputs go through
both packages on the CPU, and the port's a and b must equal tfhe_tpu's
exactly, cv to rtol 1e-6; every result also decrypts to the plaintext answer.
The JAX side of Cannon's algorithm compiles for minutes, so that comparison
is marked slow and a case of the port alone against the plaintext stays here.
A slow test recomputes the PARAMS_110 golden that chip_smoke.py holds the
card against."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import arith as ja
from tfhe_tpu import linalg as jl
from tfhe_tpu import ref_keygen as j_ref_keygen
from tfhe_tpu.apps import linreg as jlinreg
from tfhe_tpu.core.keys import keygen_reference as j_keygen_reference
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, linalg, ref_keygen
from tfhe_tpu_torch.apps import linreg
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_parity import assert_same, port_keys, to_jax, to_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 4
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_linalg_golden.json")


def _signed(v, nbits=NB):
    v = np.asarray(v, np.int64) & ((1 << nbits) - 1)
    return np.where(v >> (nbits - 1), v - (1 << nbits), v)


@pytest.fixture(scope="module")
def toy(toy_keys):
    return toy_keys, port_keys(toy_keys, pt.PARAMS_TOY)


def _enc(jsk, value, seed, nbits=NB):
    return ja.encrypt_int(jsk, np.asarray(value, np.int64), nbits, seed=seed)


A22, B22 = [[1, 2], [0, 3]], [[2, 1], [1, 1]]
A23, B32 = [[1, 2, 1], [3, 0, 2]], [[2, 1], [1, 1], [0, 3]]

# name -> (operands, plaintext answer)
CASES = {
    "vector_add": (([1, 2, 3, 4], [3, 1, 2, 2]), lambda a, b: a + b),
    "vector_mul": (([1, 2, 3, 4], [3, 1, 2, 2]), lambda a, b: a * b),
    "vector_sum": (([1, 2, 3, 1],), lambda a: a.sum()),
    "matrix_add": ((A22, B22), lambda a, b: a + b),
    "matmul": ((A22, B22), lambda a, b: a @ b),
    "matmul_2x3_3x2": ((A23, B32), lambda a, b: a @ b),
}


@pytest.mark.parametrize("name", list(CASES))
def test_linalg_matches_tfhe_tpu(toy, name):
    jsk, psk = toy
    fn = name.split("_2x3")[0]
    values, truth = CASES[name]
    cts = [_enc(jsk, v, 41 + i) for i, v in enumerate(values)]
    want = getattr(jl, fn)(*cts, jsk.cloud)
    got = getattr(linalg, fn)(*map(to_torch, cts), psk.cloud)
    assert_same(got, want)
    np.testing.assert_array_equal(arith.decrypt_int(psk, got),
                                  _signed(truth(*map(np.asarray, values))))


def test_cannon_2x2_plaintext(toy):
    """The port's Cannon matmul decrypts to a @ b and to what matmul gives."""
    jsk, psk = toy
    ca, cb = (to_torch(_enc(jsk, v, s)) for v, s in ((A22, 46), (B22, 47)))
    got = arith.decrypt_int(psk, linalg.cannon_matmul(ca, cb, psk.cloud))
    np.testing.assert_array_equal(got, np.asarray(A22) @ np.asarray(B22))
    np.testing.assert_array_equal(got, arith.decrypt_int(psk, linalg.matmul(ca, cb, psk.cloud)))


def test_cannon_3x3_plaintext(toy):
    """Three rounds of rolls: every row and column shift of the skew differs."""
    jsk, psk = toy
    a = np.array([[1, 0, 2], [1, 1, 0], [0, 2, 1]])
    b = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]])
    ca, cb = (to_torch(_enc(jsk, v, s)) for v, s in ((a, 48), (b, 49)))
    got = arith.decrypt_int(psk, linalg.cannon_matmul(ca, cb, psk.cloud))
    np.testing.assert_array_equal(got, _signed(a @ b))


@pytest.mark.slow
def test_cannon_2x2_matches_tfhe_tpu(toy):
    jsk, psk = toy
    ca, cb = _enc(jsk, A22, 46), _enc(jsk, B22, 47)
    want = jl.cannon_matmul(ca, cb, jsk.cloud)
    assert_same(linalg.cannon_matmul(to_torch(ca), to_torch(cb), psk.cloud), want)


# ----------------------------------------------------------------- linreg

def _linreg_inputs(jsk, variant, lead):
    """y = 2x + 1 over x = 1..4 (numerical) or y = 3x + 2 over bits x
    (binary), 8 bits; with `lead` a second attribute column."""
    nb = 8
    if variant == "numerical":
        x = np.array([[1, 2, 3, 4], [2, 4, 1, 3]], np.int64)
        y = np.array([2 * x[0] + 1, 3 * x[1]], np.int64)
        want = [(2, 1), (3, 0)]
    else:
        x = np.array([[0, 1, 0, 1], [1, 1, 0, 0]], np.int64)
        y = np.array([3 * x[0] + 2, 4 * x[1] + 1], np.int64)
        want = [(3, 2), (4, 1)]
    if not lead:
        x, y, want = x[0], y[0], want[0]
    cx = (jt.encrypt_bits(jsk, x.astype(np.int32), seed=73) if variant == "binary"
          else ja.encrypt_int(jsk, x, nb, seed=71))
    return cx, ja.encrypt_int(jsk, y, nb, seed=72), want


@pytest.mark.parametrize("variant,lead", [
    ("binary", False), ("binary", True),
    # the JAX side of the numerical fit alone takes over a minute
    pytest.param("numerical", False, marks=pytest.mark.slow),
    pytest.param("numerical", True, marks=pytest.mark.slow)])
def test_linreg_matches_tfhe_tpu(toy, variant, lead):
    """Both regressions at the sizes of tests/test_apps.py, and with a leading
    attribute axis ([attrs, n_rows, nbits]) as one batched fit."""
    jsk, psk = toy
    cx, cy, want = _linreg_inputs(jsk, variant, lead)
    name = "linear_regression" + ("_binary" if variant == "binary" else "")
    jb1, jb0 = getattr(jlinreg, name)(cx, cy, jsk.cloud)
    b1, b0 = getattr(linreg, name)(to_torch(cx), to_torch(cy), psk.cloud)
    assert_same(b1, jb1)
    assert_same(b0, jb0)
    got = np.stack([arith.decrypt_int(psk, b1), arith.decrypt_int(psk, b0)], axis=-1)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_linreg_numerical_plaintext():
    """The numerical fit of two attribute columns as one batch, on the port's
    own keys and encryption, decrypts to the slopes and intercepts."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(10)
    x = np.array([[1, 2, 3, 4], [2, 4, 1, 3]], np.int64)
    y = np.array([2 * x[0] + 1, 3 * x[1]], np.int64)
    b1, b0 = linreg.linear_regression(arith.encrypt_int(sk, x, 8, gen, "cpu"),
                                      arith.encrypt_int(sk, y, 8, gen, "cpu"), sk.cloud)
    assert b1.batch_shape == b0.batch_shape == (2, 8)
    np.testing.assert_array_equal(arith.decrypt_int(sk, b1), [2, 3])
    np.testing.assert_array_equal(arith.decrypt_int(sk, b0), [1, 0])


# ----------------------------------------------------------------- golden

def golden_inputs(g, lwe_key, ref):
    """The golden's operands: the reference's keygen, then its encryption of
    all the bits in one stream; cv = 0. Returns numpy (a, b, cv) per operand."""
    ref.keygen_raw(tuple(g["seed"]))
    nb = g["nbits"]
    values = [np.asarray(g[k], np.int64) for k in ("matrix_a", "matrix_b", "vector")]
    bits = np.concatenate([((v[..., None] >> np.arange(nb)) & 1).reshape(-1) for v in values])
    a, b = ref.encrypt_bits(lwe_key, bits.astype(np.int32))
    out, at = [], 0
    for v in values:
        m = v.size * nb
        shape = v.shape + (nb,)
        out.append((a[at:at + m].reshape(shape + (a.shape[-1],)), b[at:at + m].reshape(shape),
                    np.zeros(shape, np.float32)))
        at += m
    return out


def golden_hash(*cts) -> str:
    h = hashlib.sha256()
    for ct in cts:
        h.update(np.asarray(ct.a).astype("<i4").tobytes())
        h.update(np.asarray(ct.b).astype("<i4").tobytes())
    return h.hexdigest()


@pytest.mark.slow
def test_linalg_golden():
    """Recompute tests/fixtures/torch_port_linalg_golden.json with tfhe_tpu on
    the CPU (4-bit 2x2 matmul and cannon_matmul, vector_sum of 4, PARAMS_110,
    the reference's keys), and the port's plain path reproduces it."""
    with open(GOLDEN) as f:
        g = json.load(f)
    jsk = j_keygen_reference(jt.PARAMS_110, seed=tuple(g["seed"]))
    ma, mb, vec = (to_jax(LweCiphertext(*map(torch.from_numpy, v)))
                   for v in golden_inputs(g, jsk.lwe_key, j_ref_keygen))
    want = (jl.matmul(ma, mb, jsk.cloud), jl.cannon_matmul(ma, mb, jsk.cloud),
            jl.vector_sum(vec, jsk.cloud))
    assert golden_hash(*want) == g["sha256"]
    np.testing.assert_array_equal(ja.decrypt_int(jsk, want[0]), g["product"])
    np.testing.assert_array_equal(ja.decrypt_int(jsk, want[1]), g["product"])
    assert int(ja.decrypt_int(jsk, want[2])) == g["sum"]
    psk = pt.keygen_reference(pt.PARAMS_110, seed=tuple(g["seed"]), device="cpu")
    pa, pb, pv = (LweCiphertext(*map(torch.from_numpy, v))
                  for v in golden_inputs(g, psk.lwe_key, ref_keygen))
    got = (linalg.matmul(pa, pb, psk.cloud), linalg.cannon_matmul(pa, pb, psk.cloud),
           linalg.vector_sum(pv, psk.cloud))
    for p, j in zip(got, want):
        assert_same(p, j)
