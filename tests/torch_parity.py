"""Helpers of the port's parity tests: the same keys and samples as numpy go
through ``tfhe_tpu`` (JAX, on the CPU) and ``tfhe_tpu_torch`` (device "cpu").

    from torch_parity import assert_same, port_keys, to_jax, to_torch
"""
import jax.numpy as jnp
import numpy as np
import torch

from tfhe_tpu.core.lwe import LweCiphertext as JLwe
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext


def to_torch(jct) -> LweCiphertext:
    """A tfhe_tpu ciphertext batch as the port's, on the CPU."""
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def to_jax(ct: LweCiphertext) -> JLwe:
    return JLwe(*(jnp.asarray(v.cpu().numpy()) for v in (ct.a, ct.b, ct.cv)))


def assert_same(got: LweCiphertext, want) -> None:
    """a and b exact, cv to rtol 1e-6 (a float32 variance may round apart)."""
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


def port_keys(jsk, params) -> keys.SecretKeySet:
    """The port's key set on the CPU from a tfhe_tpu key set's raw numpy keys."""
    raw = [np.asarray(v) for v in (jsk.lwe_key, jsk.tlwe_key, jsk.bk_raw, jsk.ks_a, jsk.ks_b)]
    return keys.SecretKeySet(params, *raw,
                             keys.cloud_from_raw(params, raw[2], raw[3], raw[4], "cpu"))
