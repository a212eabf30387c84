"""The port's 7:3 septet compressor and +-1/16 full adder, exhaustive (PARAMS_TOY).

Twins of tests/test_compressor.py on tfhe_tpu_torch: the compressor
machinery through ``arith._wallace_sum_bits`` and the gate entry points over
exhaustive truth tables as one batch, decrypted against plain integers, and
the septet and full-adder arms of a multiply agreeing."""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core.lwe import lwe_concat
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def sk():
    return pt.keygen(pt.PARAMS_TOY, seed=(314, 1592, 657), device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bits16(sk, bits, seed=7):
    """Encrypt bits, then refresh them into the +-1/16 compressor encoding
    through an identity gate with mu = MU16 (OR(x, x) = x)."""
    ct = pt.encrypt_bits(sk, np.asarray(bits, np.int32), _gen(seed), "cpu")
    return gates.gate2("OR", ct, ct, sk.cloud, mu=gates.MU16)


def test_septet_popcount_exhaustive(sk):
    """All 128 combinations of 7 bits: one 7-high column reduces to the
    three popcount digits."""
    combos = np.array([[(v >> i) & 1 for i in range(7)] for v in range(128)])
    out = arith._wallace_sum_bits(_bits16(sk, combos), np.zeros(7, np.int64), 4, sk.cloud,
                                  amp=np.full(7, 16))
    np.testing.assert_array_equal(arith.decrypt_int(sk, out, signed=False), combos.sum(axis=1))


def test_full_adder16_exhaustive(sk):
    """All 8 combinations of (a, b, cin) at +-1/16; the sum comes out at
    +-1/8, the carry at +-1/16 (decrypt_bits reads the sign)."""
    combos = np.array([[(v >> i) & 1 for i in range(3)] for v in range(8)])
    cts = _bits16(sk, combos)
    s, c = gates.full_adder16(cts[:, 0], cts[:, 1], cts[:, 2], sk.cloud,
                              mu_sum=gates.MU, mu_carry=gates.MU16)
    tot = combos.sum(axis=1)
    np.testing.assert_array_equal(pt.decrypt_bits(sk, s), tot & 1)
    np.testing.assert_array_equal(pt.decrypt_bits(sk, c), tot >> 1)


def test_mixed_amplitude_columns(sk):
    """One column of 5 fresh +-1/8 bits and 5 compressor +-1/16 bits: the FA8
    conversion, the stall breaker and the stray-recode finale."""
    bits = np.random.RandomState(3).randint(0, 2, size=(6, 10))
    c8 = pt.encrypt_bits(sk, bits[:, :5].astype(np.int32), _gen(11), "cpu")
    cur = lwe_concat([c8, _bits16(sk, bits[:, 5:])], axis=-1)
    out = arith._wallace_sum_bits(cur, np.zeros(10, np.int64), 4, sk.cloud,
                                  amp=np.array([8] * 5 + [16] * 5))
    np.testing.assert_array_equal(arith.decrypt_int(sk, out, signed=False), bits.sum(axis=1))


def test_septet_vs_fa_paths_agree(sk):
    """The septet arm and the full-adder Dadda arm give the same truncated product."""
    a = np.array([3, 5, 7, 2], np.int64)
    b = np.array([2, 7, 5, 6], np.int64)
    ca = arith.encrypt_int(sk, a, 4, _gen(21), "cpu")
    cb = arith.encrypt_int(sk, b, 4, _gen(22), "cpu")
    got = {}
    for flag in ("1", "0"):
        with config.overrides(TFHE_TPU_SEPTET=flag):
            got[flag] = arith.decrypt_int(sk, arith.mul(ca, cb, sk.cloud))
    np.testing.assert_array_equal(got["1"], got["0"])
    want = (a * b) & 0xF
    np.testing.assert_array_equal(got["1"], np.where(want & 8, want - 16, want))
