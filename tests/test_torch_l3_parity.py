"""The port at a gadget of three levels against tfhe_tpu on the CPU.

PARAMS_TOY with PARAMS_128's gadget (l = 3, Bg = 2^7) in both packages: the
same raw keys (tfhe_tpu's keygen) and the same samples (tfhe_tpu's
encryption) through the ten gates and the bootstrap of each, word for word,
at B = 1, 7 and 33. The port's bootstrap runs by both routes (the
small-batch blind rotate and the other) with the key switch fused into the
wrapper and apart."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_tpu as jt
from tfhe_tpu import gates as jg
from tfhe_tpu.core import bootstrap as jbs
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from torch_parity import assert_same, port_keys, to_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

J_TOY_L3 = dataclasses.replace(jt.PARAMS_TOY, bk_l=3, bk_Bgbit=7)
KINDS = ("AND", "OR", "NAND", "NOR", "XOR", "XNOR", "ANDNY", "ANDYN", "ORNY", "ORYN")
TRUTH = {
    "AND": lambda a, b: a & b, "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b), "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b, "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDNY": lambda a, b: (1 - a) & b, "ANDYN": lambda a, b: a & (1 - b),
    "ORNY": lambda a, b: (1 - a) | b, "ORYN": lambda a, b: a | (1 - b),
}


@pytest.fixture(scope="module")
def toy_l3():
    """tfhe_tpu's keys at the toy l = 3 set and the port's from the same raw
    keys."""
    jsk = jt.keygen(J_TOY_L3, seed=(271, 828, 182))
    return jsk, port_keys(jsk, pt.PARAMS_TOY_L3)


def _bits(B: int, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2, size=B), rng.randint(0, 2, size=B)


def test_toy_l3_is_the_same_set_in_both_packages():
    fields = [f.name for f in dataclasses.fields(J_TOY_L3)]
    assert fields == [f.name for f in dataclasses.fields(pt.PARAMS_TOY_L3)]
    assert all(getattr(J_TOY_L3, f) == getattr(pt.PARAMS_TOY_L3, f) for f in fields)
    assert (J_TOY_L3.kpl, J_TOY_L3.decomp_offset) == (pt.PARAMS_TOY_L3.kpl,
                                                      pt.PARAMS_TOY_L3.decomp_offset)


@pytest.mark.parametrize("B", [1, 7, 33])
def test_ten_gates_at_three_levels_match_tfhe_tpu(toy_l3, B):
    jsk, psk = toy_l3
    bx, by = _bits(B, 40 + B)
    x, y = jt.encrypt_bits(jsk, bx, seed=50 + B), jt.encrypt_bits(jsk, by, seed=60 + B)
    for kind in KINDS:
        got = gates.gate2(kind, to_torch(x), to_torch(y), psk.cloud)
        assert_same(got, jg.gate2(kind, x, y, jsk.cloud))
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), TRUTH[kind](bx, by),
                                      err_msg=kind)


@pytest.mark.parametrize("B", [1, 7, 33])
def test_bootstrap_at_three_levels_matches_tfhe_tpu(toy_l3, B):
    jsk, psk = toy_l3
    bx, _ = _bits(B, 70 + B)
    x = jt.encrypt_bits(jsk, bx, seed=80 + B)
    want = jbs.bootstrap(x, jnp.int32(jg.MU), jsk.cloud)
    waves = bs.WAVES[3]
    for fuseks in ("0", "1"):
        for small_max in (B, 0):            # the small-batch blind rotate, then the other
            try:
                bs.WAVES[3] = dataclasses.replace(waves, small_batch_max=small_max)
                with config.overrides(TFHE_TPU_FUSEKS=fuseks):
                    got = bs.bootstrap(to_torch(x), gates.MU, psk.cloud)
            finally:
                bs.WAVES[3] = waves
            assert_same(got, want)
