"""The opt-in arms of tfhe_tpu_torch.arith against tfhe_tpu.arith, at
PARAMS_TOY on 8-bit operands: the parallel-prefix arm (TFHE_TPU_LOOKAHEAD=1:
add_fast, _prefix_carry_chain, _cmp_carry_tree, _or_scan_excl) and the septet
arm (TFHE_TPU_SEPTET=1: _compress_level_plan, _wallace_sum_bits_septet),
each flag flipped through both packages' config.overrides. a and b exact,
cv to rtol 1e-6; every result also against plain integer semantics."""
import numpy as np
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import arith as ja
from tfhe_tpu import config as jconfig
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NB = 8


def _signed(v):
    v = np.asarray(v, np.int64) & ((1 << NB) - 1)
    return np.where(v >> (NB - 1), v - (1 << NB), v)


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


@pytest.fixture(scope="module")
def toy8(toy_keys):
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    a = np.array([37, -61, 0, -128], np.int64)
    b = np.array([-41, 23, -1, 127], np.int64)
    cts = {"a": ja.encrypt_int(toy_keys, a, NB, seed=81),
           "b": ja.encrypt_int(toy_keys, b, NB, seed=82),
           "pa": ja.encrypt_int(toy_keys, np.abs(a) & 127, NB, seed=83),
           "pb": ja.encrypt_int(toy_keys, np.abs(b) & 127, NB, seed=84),
           "s": jt.encrypt_bits(toy_keys, np.array([1, 0, 0, 1]), seed=85)}
    return toy_keys, psk, a, b, cts


ARMS = {
    "TFHE_TPU_LOOKAHEAD": {
        "add": (("a", "b"), lambda a, b: a + b),
        "sub": (("a", "b"), lambda a, b: a - b),
        "twos_complement": (("a",), lambda a, b: -a),
        "gt": (("a", "b"), lambda a, b: (a > b).astype(np.int64)),
        "minimum": (("pa", "pb"), lambda a, b: np.minimum(np.abs(a) & 127, np.abs(b) & 127)),
        "add_sign": (("a", "s"), lambda a, b: np.where([1, 0, 0, 1], -a, a)),
        "mul": (("a", "b"), lambda a, b: a * b),
        "absolute": (("a",), lambda a, b: np.abs(a)),
        "div": (("a", "b"), lambda a, b: np.trunc(a / b).astype(np.int64)),
    },
    "TFHE_TPU_SEPTET": {
        "mul": (("a", "b"), lambda a, b: a * b),
        "mul_mux": (("a", "b"), lambda a, b: a * b),
    },
}


@pytest.mark.parametrize("flag,name", [(f, n) for f in ARMS for n in ARMS[f]])
def test_arm_matches_tfhe_tpu(toy8, flag, name):
    jsk, psk, a, b, cts = toy8
    ops, truth = ARMS[flag][name]
    with jconfig.overrides(**{flag: "1"}):
        want = getattr(ja, name)(*[cts[o] for o in ops], jsk.cloud)
    with config.overrides(**{flag: "1"}):
        got = getattr(arith, name)(*[_ct(cts[o]) for o in ops], psk.cloud)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    if got.batch_shape[-1:] == (NB,):
        np.testing.assert_array_equal(arith.decrypt_int(psk, got), _signed(truth(a, b)))
    else:
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), truth(a, b))


def test_noise_model_demotes_the_septet_arm(toy8):
    """Under the worst-case "tracked" accounting no septet is certified at
    PARAMS_110 (max_live16 < 5), so a forced TFHE_TPU_SEPTET=1 still plans the
    full-adder tree, in both packages."""
    with config.overrides(TFHE_TPU_SEPTET="1", TFHE_TPU_NOISE_MODEL="tracked"), \
            jconfig.overrides(TFHE_TPU_SEPTET="1", TFHE_TPU_NOISE_MODEL="tracked"):
        assert arith._septet_enabled(16, pt.PARAMS_110) is False
        assert ja._septet_enabled(16, jt.PARAMS_110) is False
    with config.overrides(TFHE_TPU_SEPTET="1"):
        assert arith._septet_enabled(16, pt.PARAMS_110) is True
    cc = np.repeat(np.arange(4), [7, 5, 3, 2])
    amp = np.array([16] * 12 + [8] * 5)
    assert arith._compress_level_plan(cc, amp, 4) == ja._compress_level_plan(cc, amp, 4)
