"""tfhe_tpu_torch numerics, LWE algebra, encryption, keys and routing against
tfhe_tpu on the same numpy inputs."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import numeric as jnum
from tfhe_tpu.core import lwe as jlwe
from tfhe_tpu.core.crypt import lwe_phase as j_lwe_phase
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, numeric
from tfhe_tpu_torch.core import keys, lwe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _jct(ct: lwe.LweCiphertext):
    return jlwe.LweCiphertext(jnp.asarray(ct.a.numpy()), jnp.asarray(ct.b.numpy()),
                              jnp.asarray(ct.cv.numpy()))


def _assert_ct_equal(got: lwe.LweCiphertext, want) -> None:
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


def _random_ct(rng, shape, n):
    return lwe.LweCiphertext(
        _t(rng.randint(-2 ** 31, 2 ** 31, size=shape + (n,)).astype(np.int32)),
        _t(rng.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)),
        _t(rng.rand(*shape).astype(np.float32)))


def test_params_match():
    for name in ("PARAMS_110", "PARAMS_TOY", "PARAMS_SMALL", "PARAMS_SMALL_NOISY"):
        want, got = getattr(jt, name), getattr(pt, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        for prop in ("Bg", "halfBg", "maskMod", "kpl", "decomp_offset", "h", "n_extract",
                     "ks_base", "ks_prec_offset"):
            assert getattr(got, prop) == getattr(want, prop), (name, prop)


@pytest.mark.parametrize("Msize", [8, 256, 2048, 12, 1000])
def test_mod_switch_from_torus32_matches(Msize):
    rng = np.random.RandomState(Msize)
    x = rng.randint(-2 ** 31, 2 ** 31, size=(64, 5)).astype(np.int32)
    x[0, :4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
    want = np.asarray(jnum.mod_switch_from_torus32(jnp.asarray(x), Msize))
    got = numeric.mod_switch_from_torus32(_t(x), Msize)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Msize", [8, 4, 2048, 12, 1000])
def test_mod_switch_to_torus32_matches(Msize):
    mu = np.arange(-Msize, Msize, dtype=np.int32)
    want = np.asarray(jnum.mod_switch_to_torus32(jnp.asarray(mu), Msize))
    got = numeric.mod_switch_to_torus32(_t(mu), Msize)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dtot32_matches():
    rng = np.random.RandomState(3)
    d = (rng.randn(4096) * 2.0 ** -15).astype(np.float32)
    np.testing.assert_array_equal(numeric.dtot32(_t(d)).numpy(),
                                  np.asarray(jnum.dtot32(jnp.asarray(d))))


def test_lwe_algebra_matches():
    rng = np.random.RandomState(4)
    x, y = _random_ct(rng, (3, 4), 16), _random_ct(rng, (3, 4), 16)
    jx, jy = _jct(x), _jct(y)
    _assert_ct_equal(lwe.lwe_add(x, y), jlwe.lwe_add(jx, jy))
    _assert_ct_equal(lwe.lwe_sub(x, y), jlwe.lwe_sub(jx, jy))
    _assert_ct_equal(lwe.lwe_negate(x), jlwe.lwe_negate(jx))
    _assert_ct_equal(lwe.lwe_concat([x, y], axis=-1), jlwe.lwe_concat([jx, jy], axis=-1))
    _assert_ct_equal(x[1:, 2], jx[1:, 2])
    _assert_ct_equal(x.reshape(12), jx.reshape(12))
    _assert_ct_equal(lwe.noiseless_trivial(1 << 29, 16, (2, 3), device="cpu"),
                     jlwe.noiseless_trivial(1 << 29, 16, (2, 3)))
    assert x.batch_shape == jx.batch_shape and x.n == jx.n == 16


@pytest.mark.parametrize("p", [0, 1, 3, -7, 1 << 20])
def test_lwe_add_mul_sub_mul_match(p):
    """x + p*y and x - p*y (ref lweAddMulTo, lweSubMulTo) with int32 wrap:
    a and b exact, cv to rtol 1e-6."""
    rng = np.random.RandomState(5)
    x, y = _random_ct(rng, (3, 4), 16), _random_ct(rng, (3, 4), 16)
    jx, jy = _jct(x), _jct(y)
    _assert_ct_equal(lwe.lwe_add_mul(x, p, y), jlwe.lwe_add_mul(jx, p, jy))
    _assert_ct_equal(lwe.lwe_sub_mul(x, p, y), jlwe.lwe_sub_mul(jx, p, jy))


def test_lwe_phase_matches(toy_keys):
    rng = np.random.RandomState(5)
    x = _random_ct(rng, (7,), toy_keys.params.n)
    key = toy_keys.lwe_key
    want = np.asarray(j_lwe_phase(_jct(x), jnp.asarray(key)))
    np.testing.assert_array_equal(pt.lwe_phase(x, _t(key)).numpy(), want)


def _jax_cloud_arrays(sk):
    return {f: np.asarray(getattr(sk.cloud, f)) for f in
            ("bk_ntt", "bk_ntt_shoup", "bk_rows", "bk_rows_shoup", "ks_table", "ks_table_perm")}


@pytest.mark.parametrize("which", ["toy_keys", "small_keys"])
def test_cloud_from_raw_byte_identical(which, request):
    """The weights carry-over: the same raw keys give every CloudKey array of
    tfhe_tpu, dtype and bytes."""
    sk = request.getfixturevalue(which)
    params = getattr(pt, "PARAMS_TOY" if which == "toy_keys" else "PARAMS_SMALL")
    cloud = keys.cloud_from_raw(params, sk.bk_raw, sk.ks_a, sk.ks_b, "cpu")
    for name, want in _jax_cloud_arrays(sk).items():
        got = getattr(cloud, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    moved = cloud.to("cpu")
    assert moved.params == params and torch.equal(moved.bk_rows, cloud.bk_rows)


@pytest.mark.parametrize("params", [pt.PARAMS_TOY, pt.PARAMS_SMALL_NOISY],
                         ids=["toy", "small_noisy"])
def test_keygen_encrypt_decrypt_roundtrip(params):
    """Torch-PRNG keys cannot match jax's draws; they are checked by
    decryption (the secret key set decrypts what it encrypts, and the
    bootstrapping and key-switch keys decrypt to their messages)."""
    sk = pt.keygen(params, seed=(3, 1, 4), device="cpu")
    sk2 = pt.keygen(params, seed=(3, 1, 4), device="cpu")
    assert np.array_equal(sk.bk_raw, sk2.bk_raw) and np.array_equal(sk.ks_a, sk2.ks_a)
    gen = torch.Generator().manual_seed(5)
    bits = np.random.RandomState(6).randint(0, 2, 64)
    ct = pt.encrypt_bits(sk, bits, gen, "cpu")
    assert ct.a.shape == (64, params.n) and ct.a.dtype == torch.int32
    np.testing.assert_array_equal(pt.decrypt_bits(sk, ct), bits)
    # key-switch rows: b - a.s == ext_key[i] * h * 2^(32-(j+1)*basebit) + small noise
    ks_a, ks_b = sk.ks_a[:, :, 1:], sk.ks_b[:, :, 1:]
    phase = (ks_b.astype(np.int64) - (ks_a.astype(np.int64) * sk.lwe_key).sum(-1))
    t, base = params.ks_t, params.ks_base
    mess = (sk.tlwe_key.reshape(-1)[:, None, None] * np.arange(1, base)[None, None, :]
            * (1 << (32 - (np.arange(t)[None, :, None] + 1) * params.ks_basebit)))
    err = ((phase - mess + 2 ** 31) % 2 ** 32) - 2 ** 31
    assert np.abs(err).max() < 2 ** 22
    # bootstrapping key: row (c*l + p) of sample i has phase s_i * h[p] at X^0 of block c
    N, k = params.N, params.k
    bk = torch.from_numpy(sk.bk_raw)
    s = torch.from_numpy(sk.tlwe_key)
    body = bk[:, :, k] - pt.ntt.negacyclic_polymul_i32(s[None, None, 0], bk[:, :, 0])
    for p in range(params.bk_l):
        got = body[:, k * params.bk_l + p, 0].numpy().astype(np.int64)
        want = sk.lwe_key.astype(np.int64) * params.h[p]
        assert np.abs(((got - want + 2 ** 31) % 2 ** 32) - 2 ** 31).max() < 2 ** 12


def test_fuseks_routing(monkeypatch):
    monkeypatch.delenv("TFHE_TPU_FUSEKS", raising=False)
    assert not config.fuseks_enabled(torch.device("cpu"))
    assert config.fuseks_enabled(torch.device("cuda"))
    monkeypatch.setenv("TFHE_TPU_FUSEKS", "1")
    assert config.fuseks_enabled(torch.device("cpu"))
    with config.overrides(TFHE_TPU_FUSEKS="0"):
        assert not config.fuseks_enabled(torch.device("cuda"))
    assert config.fuseks_enabled(torch.device("cpu"))
