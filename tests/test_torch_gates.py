"""tfhe_tpu_torch.gates against tfhe_tpu.gates and the truth tables.

All ten two-input gates, the compound pair, MUX and the unbootstrapped gates
at PARAMS_TOY; then the slice as a whole at PARAMS_110 with the reference's
keys: AND at B = 2 byte-equal to tfhe_tpu, and the golden 8-input AND that
chip_smoke.py checks on the card (tests/fixtures/torch_port_and_golden.json)."""
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import gates as jg
from tfhe_tpu import ref_keygen as j_ref_keygen
from tfhe_tpu.core.keys import keygen_reference as j_keygen_reference
from tfhe_tpu.core.lwe import LweCiphertext as JLwe
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, gates, ref_keygen
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_and_golden.json")

TRUTH = {
    "AND": lambda a, b: a & b, "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b), "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDNY": lambda a, b: (1 - a) & b, "ANDYN": lambda a, b: a & (1 - b),
    "ORNY": lambda a, b: (1 - a) | b, "ORYN": lambda a, b: a | (1 - b),
}


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def _assert_same(got: LweCiphertext, want) -> None:
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def toy(toy_keys):
    """The JAX toy keys, the port's key set from the same raw keys, and the
    16 input combinations of three bits encrypted by tfhe_tpu."""
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    bits = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)] * 2)
    cts = [jt.encrypt_bits(toy_keys, bits[:, i], seed=30 + i) for i in range(3)]
    return toy_keys, psk, bits, cts


@pytest.mark.parametrize("name", sorted(TRUTH))
def test_gate_matches_tfhe_tpu(toy, name):
    jsk, psk, bits, (x, y, _) = toy
    want = jg.gate2(name, x, y, jsk.cloud)
    got = getattr(gates, name)(_ct(x), _ct(y), psk.cloud)     # the named gate -> gate2
    _assert_same(got, want)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, got),
                                  TRUTH[name](bits[:, 0], bits[:, 1]))


def test_gate_pair_and_batch_shape(toy):
    jsk, psk, bits, (x, y, _) = toy
    w1, w2 = jg.gate2_pair("AND", "XOR", x, y, x, y, jsk.cloud)
    g1, g2 = gates.gate2_pair("AND", "XOR", _ct(x), _ct(y), _ct(x), _ct(y), psk.cloud)
    _assert_same(g1, w1)
    _assert_same(g2, w2)
    # a [4, 4] batch gives the same samples as the flat batch of 16
    g2d = gates.OR(_ct(x).reshape(4, 4), _ct(y).reshape(4, 4), psk.cloud)
    assert g2d.batch_shape == (4, 4)
    _assert_same(g2d.reshape(16), jg.OR(x, y, jsk.cloud))


def test_mux_matches_tfhe_tpu(toy):
    jsk, psk, bits, (x, y, z) = toy
    want = jg.MUX(x, y, z, jsk.cloud)
    got = gates.MUX(_ct(x), _ct(y), _ct(z), psk.cloud)
    _assert_same(got, want)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, got),
                                  np.where(bits[:, 0] == 1, bits[:, 1], bits[:, 2]))


def test_not_copy_constant_match(toy):
    jsk, psk, bits, (x, _, _) = toy
    _assert_same(gates.NOT(_ct(x)), jg.NOT(x))
    _assert_same(gates.COPY(_ct(x)), jg.COPY(x))
    _assert_same(gates.CONSTANT([1, 0, 1], 16, (3,), device="cpu"), jg.CONSTANT(jnp.asarray([1, 0, 1]), 16, (3,)))
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gates.NOT(_ct(x))), 1 - bits[:, 0])


def test_fused_route_gate_on_cpu(toy):
    """The fused key-switch route (its plain version on the CPU) gives the
    same AND as the split route."""
    jsk, psk, bits, (x, y, _) = toy
    split = gates.AND(_ct(x), _ct(y), psk.cloud)
    with config.overrides(TFHE_TPU_FUSEKS="1"):
        fused = gates.AND(_ct(x), _ct(y), psk.cloud)
    assert torch.equal(fused.a, split.a) and torch.equal(fused.b, split.b)


def test_port_keys_end_to_end():
    """Keys, encryption and an AND chain made by the port alone decrypt right."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(10)
    rng = np.random.RandomState(11)
    a, b = rng.randint(0, 2, 12), rng.randint(0, 2, 12)
    x, y = pt.encrypt_bits(sk, a, gen, "cpu"), pt.encrypt_bits(sk, b, gen, "cpu")
    z = gates.AND(gates.XOR(x, y, sk.cloud), y, sk.cloud)
    np.testing.assert_array_equal(pt.decrypt_bits(sk, z), (a ^ b) & b)


# ------------------------------------------------- PARAMS_110, reference keys

def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _sha(a, b) -> str:
    return hashlib.sha256(np.asarray(a).astype("<i4").tobytes()
                          + np.asarray(b).astype("<i4").tobytes()).hexdigest()


@pytest.fixture(scope="module")
def ref110():
    """Both packages' reference-PRNG keys at PARAMS_110, each followed at
    once by the golden inputs' encryption, which continues that library's
    PRNG stream."""
    g = _golden()
    seed = tuple(g["seed"])
    bits = g["x_bits"] + g["y_bits"]
    jsk = j_keygen_reference(jt.PARAMS_110, seed=seed)
    j_ab = j_ref_keygen.encrypt_bits(jsk.lwe_key, bits)
    psk = pt.keygen_reference(pt.PARAMS_110, seed=seed, device="cpu")
    p_ab = ref_keygen.encrypt_bits(psk.lwe_key, bits)
    return g, jsk, j_ab, psk, p_ab


def _pairs(ab, rows, n):
    a, b = ab
    return [(a[rows + off], b[rows + off]) for off in (0, n)]


def test_reference_keys_and_inputs_identical(ref110):
    g, jsk, j_ab, psk, p_ab = ref110
    for name in ("lwe_key", "tlwe_key", "bk_raw", "ks_a", "ks_b"):
        np.testing.assert_array_equal(getattr(psk, name), getattr(jsk, name), err_msg=name)
    np.testing.assert_array_equal(p_ab[0], j_ab[0])
    np.testing.assert_array_equal(p_ab[1], j_ab[1])
    assert psk.cloud.ks_table_perm.numpy().tobytes() == np.asarray(jsk.cloud.ks_table_perm).tobytes()


def test_and_110_matches_tfhe_tpu(ref110):
    """The slice as a whole: AND at PARAMS_110, B = 2, byte-equal to tfhe_tpu."""
    g, jsk, j_ab, psk, p_ab = ref110
    n = len(g["x_bits"])
    rows = np.arange(2)
    (xa, xb), (ya, yb) = _pairs(p_ab, rows, n)
    zeros = np.zeros(2, np.float32)
    want = jg.AND(JLwe(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(zeros)),
                  JLwe(jnp.asarray(ya), jnp.asarray(yb), jnp.asarray(zeros)), jsk.cloud)
    got = gates.AND(LweCiphertext(*map(torch.from_numpy, (xa, xb, zeros))),
                    LweCiphertext(*map(torch.from_numpy, (ya, yb, zeros))), psk.cloud)
    _assert_same(got, want)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, got),
                                  np.array(g["x_bits"])[:2] & np.array(g["y_bits"])[:2])


def test_golden_and_hash(ref110):
    """tfhe_tpu and the port's plain path both reproduce the golden SHA-256,
    so the file chip_smoke.py holds the card's kernels against cannot rot."""
    g, jsk, j_ab, psk, p_ab = ref110
    n = len(g["x_bits"])
    rows = np.arange(n)
    (xa, xb), (ya, yb) = _pairs(j_ab, rows, n)
    zeros = np.zeros(n, np.float32)
    want = jg.AND(JLwe(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(zeros)),
                  JLwe(jnp.asarray(ya), jnp.asarray(yb), jnp.asarray(zeros)), jsk.cloud)
    assert _sha(want.a, want.b) == g["sha256"]
    (xa, xb), (ya, yb) = _pairs(p_ab, rows, n)
    got = gates.AND(LweCiphertext(*map(torch.from_numpy, (xa, xb, zeros))),
                    LweCiphertext(*map(torch.from_numpy, (ya, yb, zeros))), psk.cloud)
    assert _sha(got.a.numpy(), got.b.numpy()) == g["sha256"]
    np.testing.assert_array_equal(pt.decrypt_bits(psk, got),
                                  np.array(g["x_bits"]) & np.array(g["y_bits"]))
