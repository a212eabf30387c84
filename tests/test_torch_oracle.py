"""tfhe_tpu_torch.oracle and the port's numerics and plain bootstrap pieces.

Twins of tests/test_numeric.py and tests/test_bootstrap.py: every stage of
the port's plain path (mod switch, approx_phase, rotate, gadget decompose,
external product, extract, key switch, the whole bootstrap) equals the
port's own numpy oracle, which imports nothing of tfhe_tpu, and that oracle
equals tfhe_tpu.oracle on the same inputs, bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import numeric as jnum
from tfhe_tpu import oracle as joracle
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import numeric, oracle
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from torch_parity import port_keys
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_i32(rng, shape):
    return rng.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def toy(toy_keys):
    return toy_keys, port_keys(toy_keys, pt.PARAMS_TOY)


# ------------------------------------------------------------------ numerics

@pytest.mark.parametrize("Msize", [2048, 256, 8, 3, 5, 100, 1000])
def test_mod_switch_from_torus32(Msize):
    phases = _rand_i32(np.random.RandomState(0), 4096)
    want = oracle.mod_switch_from_torus32(phases, Msize)
    np.testing.assert_array_equal(numeric.mod_switch_from_torus32(_t(phases), Msize).numpy(), want)
    np.testing.assert_array_equal(want, joracle.mod_switch_from_torus32(phases, Msize))


@pytest.mark.parametrize("Msize", [8, 4, 2048, 3, 7, 12])
def test_mod_switch_to_torus32(Msize):
    mus = list(range(-8, 9)) + [-Msize, Msize, Msize - 1]
    want = np.array([oracle.mod_switch_to_torus32(mu, Msize) for mu in mus])
    got = numeric.mod_switch_to_torus32(mus, Msize, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, [joracle.mod_switch_to_torus32(mu, Msize) for mu in mus])


@pytest.mark.parametrize("Msize", [8, 2048, 3, 100])
def test_approx_phase(Msize):
    """The port's approx_phase against its oracle, tfhe_tpu's oracle and
    tfhe_tpu.numeric.approx_phase."""
    phases = _rand_i32(np.random.RandomState(0), 1024)
    want = oracle.approx_phase(phases, Msize)
    np.testing.assert_array_equal(numeric.approx_phase(_t(phases), Msize).numpy(), want)
    np.testing.assert_array_equal(want, joracle.approx_phase(phases, Msize))
    np.testing.assert_array_equal(want, np.asarray(jnum.approx_phase(jnp.asarray(phases), Msize)))


def test_t32tod_matches_tfhe_tpu():
    x = np.concatenate([np.array([-1, 0, 1, -(2 ** 31), 2 ** 31 - 1], np.int32),
                        _rand_i32(np.random.RandomState(1), 256)])
    got = numeric.t32tod(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnum.t32tod(jnp.asarray(x))))


# ------------------------------------------------------------------ the oracle itself

def test_oracle_is_tfhe_tpus_on_the_same_inputs(toy):
    """Every stage of the port's oracle against tfhe_tpu.oracle."""
    jsk, psk = toy
    params = psk.params
    rng = np.random.RandomState(3)
    N = params.N
    small = rng.randint(-512, 512, size=N).astype(np.int32)
    poly = _rand_i32(rng, N)
    np.testing.assert_array_equal(oracle.negacyclic_polymul(small, poly),
                                  joracle.negacyclic_polymul(small, poly))
    for amt in (0, 1, N - 1, N, N + 5, 2 * N - 1):
        np.testing.assert_array_equal(oracle.mul_by_xai(amt, poly), joracle.mul_by_xai(amt, poly))
    np.testing.assert_array_equal(oracle.decompose(poly, params), joracle.decompose(poly, params))
    acc = _rand_i32(rng, (params.k + 1, N))
    np.testing.assert_array_equal(oracle.extern_product(acc, params, psk.bk_raw[1]),
                                  joracle.extern_product(acc, params, jsk.bk_raw[1]))
    for got, want in zip(oracle.sample_extract(acc, params), joracle.sample_extract(acc, params)):
        np.testing.assert_array_equal(got, want)
    a_ext = _rand_i32(rng, params.n_extract)
    for got, want in zip(oracle.key_switch(a_ext, 77, psk.ks_a, psk.ks_b, params),
                         joracle.key_switch(a_ext, 77, jsk.ks_a, jsk.ks_b, params)):
        np.testing.assert_array_equal(got, want)
    a, b = _rand_i32(rng, params.n), np.int32(12345)
    assert oracle.lwe_phase(a, b, psk.lwe_key) == joracle.lwe_phase(a, b, jsk.lwe_key)
    np.testing.assert_array_equal(oracle.tlwe_phase(acc[:1], acc[1], psk.tlwe_key),
                                  joracle.tlwe_phase(acc[:1], acc[1], jsk.tlwe_key))
    for got, want in zip(oracle.bootstrap(a, b, 1 << 29, psk.bk_raw, psk.ks_a, psk.ks_b, params),
                         joracle.bootstrap(a, b, 1 << 29, jsk.bk_raw, jsk.ks_a, jsk.ks_b, params)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ the plain path, stage by stage

def test_rotate_matches_oracle(toy):
    params = toy[1].params
    N = params.N
    rng = np.random.RandomState(5)
    x = _rand_i32(rng, (7, 2, N))
    amounts = rng.randint(0, 2 * N, size=7).astype(np.int32)
    got = bs.negacyclic_rotate(_t(x), _t(amounts)).numpy()
    for b in range(7):
        for c in range(2):
            np.testing.assert_array_equal(got[b, c], oracle.mul_by_xai(int(amounts[b]), x[b, c]))


def test_decompose_matches_oracle(toy):
    params = toy[1].params
    rng = np.random.RandomState(6)
    x = _rand_i32(rng, (5, params.k + 1, params.N))
    got = bs.gadget_decompose(_t(x), params).numpy()
    for b in range(5):
        for c in range(params.k + 1):
            np.testing.assert_array_equal(got[b, c * params.bk_l:(c + 1) * params.bk_l],
                                          oracle.decompose(x[b, c], params))


def test_extern_product_matches_oracle(toy):
    psk = toy[1]
    params = psk.params
    rng = np.random.RandomState(7)
    acc = _rand_i32(rng, (3, params.k + 1, params.N))
    j = 2
    dec = bs.gadget_decompose(_t(acc), params)
    got = bs.extern_product_ntt(dec, psk.cloud.bk_ntt[j], psk.cloud.bk_ntt_shoup[j], params).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.extern_product(acc[b], params, psk.bk_raw[j]))


def test_extract_and_key_switch_match_oracle(toy):
    psk = toy[1]
    params = psk.params
    rng = np.random.RandomState(9)
    acc = _rand_i32(rng, (4, params.k + 1, params.N))
    a_ext, b_ext = bs.sample_extract(_t(acc), params)
    out = bs.key_switch(a_ext, b_ext, psk.cloud.ks_table, torch.zeros(4), params)
    for i in range(4):
        want_a, want_b = oracle.sample_extract(acc[i], params)
        np.testing.assert_array_equal(a_ext[i].numpy(), want_a)
        assert int(b_ext[i]) == int(want_b)
        ks_a, ks_b = oracle.key_switch(want_a, want_b, psk.ks_a, psk.ks_b, params)
        np.testing.assert_array_equal(out.a[i].numpy(), ks_a)
        assert int(out.b[i]) == int(ks_b)


@pytest.mark.parametrize("fuseks", ["0", "1"])
def test_full_bootstrap_matches_oracle(toy, fuseks):
    """The whole bootstrap on either route equals the oracle's, one sample at
    a time (the reference's algorithm with exact polynomial products)."""
    psk = toy[1]
    params = psk.params
    rng = np.random.RandomState(8)
    B = 4
    a = _rand_i32(rng, (B, params.n))
    b = _rand_i32(rng, B)
    mu = 1 << 29
    with pt.config.overrides(TFHE_TPU_FUSEKS=fuseks):
        out = bs.bootstrap(LweCiphertext(_t(a), _t(b), torch.zeros(B)), mu, psk.cloud)
    for i in range(B):
        want_a, want_b = oracle.bootstrap(a[i], b[i], mu, psk.bk_raw, psk.ks_a, psk.ks_b, params)
        np.testing.assert_array_equal(out.a[i].numpy(), want_a)
        assert int(out.b[i]) == int(want_b)
