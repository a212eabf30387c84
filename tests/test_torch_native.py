"""The native C++ engine (native/tfhe_ref.cpp, through tfhe_tpu_torch.native_ref)
against the port's plain path and its numpy oracle: exact, bit for bit, with
no JAX between them. Twins of tests/test_native.py; they skip without g++."""
import subprocess

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, gates, native_ref, oracle
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def sk():
    try:
        native_ref.build()
    except (OSError, subprocess.CalledProcessError) as e:     # no g++, or it failed
        pytest.skip(f"no g++ toolchain: {e}")
    return pt.keygen(pt.PARAMS_TOY, seed=(314, 1592, 657), device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_native_polymul(sk):
    rng = np.random.RandomState(0)
    a = rng.randint(-512, 512, size=128).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=128).astype(np.int32)
    np.testing.assert_array_equal(native_ref.polymul(a, b), oracle.negacyclic_polymul(a, b))


@pytest.mark.parametrize("fuseks", ["0", "1"])
def test_native_bootstrap_matches_the_plain_path(sk, fuseks):
    params = sk.params
    rng = np.random.RandomState(1)
    B = 4
    a = rng.randint(-(2 ** 31), 2 ** 31, size=(B, params.n)).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=(B,)).astype(np.int32)
    mu = 1 << 29
    na, nb = native_ref.bootstrap_batch(sk, a, b, mu)
    with pt.config.overrides(TFHE_TPU_FUSEKS=fuseks):
        out = bs.bootstrap(LweCiphertext(torch.from_numpy(a), torch.from_numpy(b),
                                         torch.zeros(B)), mu, sk.cloud)
    np.testing.assert_array_equal(na, out.a.numpy())
    np.testing.assert_array_equal(nb, out.b.numpy())


@pytest.mark.parametrize("name", ["AND", "XOR", "NAND"])
def test_native_gate_matches_the_port(sk, name):
    """A batch of native gates: the port's gate2 bytes and the truth table."""
    A = np.array([0, 0, 1, 1], np.int32)
    B_ = np.array([0, 1, 0, 1], np.int32)
    ca = pt.encrypt_bits(sk, A, _gen(71), "cpu")
    cb = pt.encrypt_bits(sk, B_, _gen(72), "cpu")
    oa, ob = native_ref.gate2_batch(sk, name, ca.a.numpy(), ca.b.numpy(), cb.a.numpy(),
                                    cb.b.numpy())
    want = gates.gate2(name, ca, cb, sk.cloud)
    np.testing.assert_array_equal(oa, want.a.numpy())
    np.testing.assert_array_equal(ob, want.b.numpy())
    truth = {"AND": A & B_, "XOR": A ^ B_, "NAND": 1 - (A & B_)}[name]
    out = LweCiphertext(torch.from_numpy(oa), torch.from_numpy(ob), torch.zeros(4))
    np.testing.assert_array_equal(pt.decrypt_bits(sk, out), truth)


def test_native_ripple_add(sk):
    """The native adder (cpuParallel Cipher::operator+ twin) decrypts to the
    4-bit two's-complement sum."""
    nb = 4
    a = np.array([3, 7, -8], np.int64)
    b = np.array([2, 1, 3], np.int64)
    ca = arith.encrypt_int(sk, a, nb, _gen(91), "cpu")
    cb = arith.encrypt_int(sk, b, nb, _gen(92), "cpu")
    oa, ob = native_ref.ripple_add(sk, ca.a.numpy(), ca.b.numpy(), cb.a.numpy(), cb.b.numpy())
    out = LweCiphertext(torch.from_numpy(oa), torch.from_numpy(ob), torch.zeros(ob.shape))
    np.testing.assert_array_equal(arith.decrypt_int(sk, out), [5, -8, -5])
    assert native_ref.num_threads() >= 1


def test_native_rejects_wrong_shapes(sk):
    with pytest.raises(ValueError, match="samples"):
        native_ref.bootstrap_batch(sk, np.zeros((2, sk.params.n + 1), np.int32),
                                   np.zeros(2, np.int32), 1 << 29)
