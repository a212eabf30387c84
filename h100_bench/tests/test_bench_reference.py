"""The plain reference equals the program's plain path word for word at
small parameter sets on the CPU, and the plaintext meaning of each answer
equals what the program's circuits decrypt to. (This test imports both; the
reference itself imports nothing of the program.)"""
import numpy as np
import pytest
import torch

import keys as K
import reference as ref
import run
import tfhe_tpu_torch as tt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.keys import cloud_from_raw
from tfhe_tpu_torch.core.lwe import LweCiphertext


def _setup(P, seed):
    keys = K.keygen(run.bench_params(P), seed, "cpu")
    cloud = cloud_from_raw(P, keys.bk.numpy(), keys.ks_a.numpy(), keys.ks_b.numpy(), "cpu")
    return keys, cloud


def _encrypt(keys, bits, g):
    return LweCiphertext(*K.encrypt_bits(keys, bits, g))


@pytest.mark.parametrize("P", [tt.PARAMS_TOY, tt.PARAMS_SMALL_NOISY], ids=["toy", "small"])
@pytest.mark.parametrize("kind", sorted(ref.GATES))
def test_gate_equals_the_program_word_for_word(P, kind):
    keys, cloud = _setup(P, 2 ** 31 + 5)
    g = K.generator(9, "cpu", "t")
    bx, by = (torch.randint(0, 2, (12,), generator=g) for _ in range(2))
    x, y = _encrypt(keys, bx, g), _encrypt(keys, by, g)
    out = tt.gates.gate2(kind, x, y, cloud)
    a, b = ref.gate(keys, kind, x.a, x.b, y.a, y.b)
    assert torch.equal(a, out.a) and torch.equal(b, out.b)
    bits, margin = K.decrypt_bits(keys, out.a, out.b)
    assert torch.equal(bits, ref.TRUTH[kind](bx, by).to(torch.int32))
    assert float(margin.max()) < 0.5


def test_bootstrap_with_an_amplitude_a_sample_and_without_key_switch():
    P = tt.PARAMS_SMALL_NOISY
    keys, cloud = _setup(P, 77)
    g = K.generator(4, "cpu", "t")
    x = _encrypt(keys, torch.randint(0, 2, (10,), generator=g), g)
    mu = torch.tensor([1 << 28, -(1 << 28), 1 << 29, -(1 << 29), 1 << 27] * 2, dtype=torch.int32)
    out = bs.bootstrap(x, mu, cloud)
    assert all(torch.equal(u, v) for u, v in zip(ref.bootstrap(keys, x.a, x.b, mu),
                                                  (out.a, out.b)))
    a_ext, b_ext, _ = bs.bootstrap_woks(x, mu, cloud)
    ra, rb = ref.rotate_extract(keys, x.a, x.b, mu, rows=3)     # in blocks of rows
    assert torch.equal(K.wrap32(ra), a_ext) and torch.equal(K.wrap32(rb), b_ext)


def test_float32_differs_from_the_exact_product():
    keys, cloud = _setup(tt.PARAMS_SMALL_NOISY, 3)
    g = K.generator(5, "cpu", "t")
    x = _encrypt(keys, torch.randint(0, 2, (8,), generator=g), g)
    exact = ref.bootstrap(keys, x.a, x.b)
    low = ref.bootstrap(keys, x.a, x.b, dtype=torch.float32)
    assert not torch.equal(exact[0], low[0])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "gt", "eq", "abs", "min", "div"])
def test_plaintext_meaning_of_each_cipher_op(op):
    import harness as H
    OPS = H.sender("cipher_ops").OPS
    P, nbits = tt.PARAMS_TOY, 4
    keys, cloud = _setup(P, 11)
    rng = np.random.default_rng(1)
    lo, hi = (0, 7) if op == "min" else (-7, 7)
    a = rng.integers(lo, hi + 1, size=6)
    b = rng.integers(lo, hi + 1, size=6)
    if op == "div":
        b = np.where(b == 0, 3, b)
    g = K.generator(6, "cpu", "t")
    A = tt.CipherInt(_encrypt(keys, torch.as_tensor(ref.int_bits(a, nbits)), g), cloud)
    B = tt.CipherInt(_encrypt(keys, torch.as_tensor(ref.int_bits(b, nbits)), g), cloud)
    out = OPS[op](A, B)
    bits, _ = K.decrypt_bits(keys, out.a, out.b)
    bits = bits.numpy()
    got = bits if op in ("gt", "eq") else ref.bits_int(bits)
    want = [ref.cipher_op(op, int(u), int(v), nbits) for u, v in zip(a, b)]
    assert list(np.asarray(got).reshape(-1)) == want


def test_plaintext_matmul_equals_the_programs():
    P, nbits = tt.PARAMS_TOY, 4
    keys, cloud = _setup(P, 12)
    rng = np.random.default_rng(2)
    a, b = rng.integers(-8, 8, size=(2, 3)), rng.integers(-8, 8, size=(3, 2))
    g = K.generator(7, "cpu", "t")
    A = _encrypt(keys, torch.as_tensor(ref.int_bits(a, nbits)), g)
    B = _encrypt(keys, torch.as_tensor(ref.int_bits(b, nbits)), g)
    out = tt.linalg.matmul(A, B, cloud)
    bits, _ = K.decrypt_bits(keys, out.a, out.b)
    assert np.array_equal(ref.bits_int(bits.numpy()), ref.matmul(a, b, nbits))
