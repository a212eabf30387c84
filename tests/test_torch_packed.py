"""The small-batch blind rotate of tfhe_tpu_torch (ops.cmux_packed, K5) and
the pieces of the serial-circuit path around it, against tfhe_tpu.

The JAX packed kernel runs in interpret mode, as tests/test_pallas_kernel.py
runs it on the CPU; the port's wrappers take their plain versions for CPU
tensors. The CUDA kernel is held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import config as jconfig
from tfhe_tpu.core import lwe as jlwe
from tfhe_tpu.ops import cmux_pallas as jcp
from tfhe_tpu.ops import cmux_pallas_packed as jcpp
from tfhe_tpu.utils import phasesim as jphasesim
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys, lwe
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import phasesim
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _cloud(jsk, params):
    return keys.cloud_from_raw(params, jsk.bk_raw, jsk.ks_a, jsk.ks_b, "cpu")


def _rand_i32(rng, shape):
    return rng.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)


def _packed_inputs(params, B, seed):
    rng = np.random.RandomState(seed)
    acc = _rand_i32(rng, (B, params.k + 1, params.N))
    bara = rng.randint(0, 2 * params.N, size=(params.n, B)).astype(np.int32)
    acc_p = acc.transpose(1, 0, 2).reshape((params.k + 1) * B, params.N // 128, 128)
    return np.ascontiguousarray(acc_p), bara


# ------------------------------------------------------------------ K5

@pytest.mark.parametrize("B", [1, 3])
def test_packed_plain_matches_pallas(small_keys, B):
    """K5's plain version against the JAX kernel in interpret mode,
    PARAMS_SMALL on real keys: the accumulators byte-identical."""
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    acc_p, bara = _packed_inputs(params, B, 20 + B)
    want = np.asarray(jcpp.blind_rotate_fused_packed(
        jnp.asarray(acc_p), jnp.asarray(bara), small_keys.cloud.bk_ntt,
        small_keys.cloud.bk_ntt_shoup, params, interpret=True))
    before = dict(cmux.LAUNCHES)
    got = cmux_packed.blind_rotate_fused_packed(_t(acc_p), _t(bara), cloud.bk_ntt,
                                                cloud.bk_ntt_shoup, params)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cmux.LAUNCHES == before     # CPU tensors take the plain version


def test_packed_ks_plain_matches_tfhe_tpu(small_keys):
    """The chained route (K5, extract, key switch) gives the (r, ext) of
    tfhe_tpu's fused kernel in interpret mode, PARAMS_SMALL, B = 2."""
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    acc_p, bara = _packed_inputs(params, 2, 30)
    acc_t = acc_p.reshape(params.k + 1, 2, params.N).transpose(0, 2, 1)
    wr, wext = jcp.blind_rotate_ks_fused(
        jnp.asarray(acc_t), jnp.asarray(bara), small_keys.cloud.bk_rows,
        small_keys.cloud.bk_rows_shoup, jcp.lane_ks_table(small_keys.cloud), params,
        interpret=True)
    gr, gext = cmux_packed.blind_rotate_packed_ks_fused(
        _t(acc_t), _t(bara), cloud.bk_ntt, cloud.bk_ntt_shoup, cloud.ks_table_perm, params)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gext.numpy(), np.asarray(wext))


# ------------------------------------------------------------------ routing

class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("fuseks", ["0", "1"], ids=["split", "fused"])
def test_small_batches_route_to_k5(toy_keys, monkeypatch, fuseks):
    """A flat batch <= SMALL_BATCH_MAX reaches a K5 wrapper and a larger one
    does not. (Both routes against tfhe_tpu: test_torch_bootstrap.py, whose
    batch of 96 takes K5, and the gate and circuit tests.)"""
    params = pt.PARAMS_TOY
    cloud = _cloud(toy_keys, params)
    names = (("blind_rotate_fused_packed", "blind_rotate_fused") if fuseks == "0" else
             ("blind_rotate_packed_ks_fused", "blind_rotate_ks_fused"))
    small_spy = _Spy(getattr(cmux_packed, names[0]))
    large_spy = _Spy(getattr(cmux, names[1]))
    monkeypatch.setattr(cmux_packed, names[0], small_spy)
    monkeypatch.setattr(cmux, names[1], large_spy)
    rng = np.random.RandomState(31)
    for B, hits in ((2, (1, 0)), (bs.SMALL_BATCH_MAX, (2, 0)), (bs.SMALL_BATCH_MAX + 1, (2, 1))):
        x = lwe.LweCiphertext(_t(_rand_i32(rng, (B, params.n))), _t(_rand_i32(rng, (B,))),
                              torch.zeros(B))
        with config.overrides(TFHE_TPU_FUSEKS=fuseks):
            got = bs.bootstrap(x, gates.MU, cloud)
        assert got.a.shape == (B, params.n)
        assert (small_spy.calls, large_spy.calls) == hits, B
    assert bs.SMALL_BATCH_MAX >= 2


# ------------------------------------------------------------------ lwe

def test_lwe_stack_and_take_match():
    rng = np.random.RandomState(40)
    cts = [jlwe.LweCiphertext(jnp.asarray(_rand_i32(rng, (3, 5, 16))),
                              jnp.asarray(_rand_i32(rng, (3, 5))),
                              jnp.asarray(rng.rand(3, 5).astype(np.float32)))
           for _ in range(2)]
    mine = [lwe.LweCiphertext(_t(c.a), _t(c.b), _t(c.cv)) for c in cts]
    for axis in (0, -1, 1):
        w, g = jlwe.lwe_stack(cts, axis=axis), lwe.lwe_stack(mine, axis=axis)
        for f in ("a", "b", "cv"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
    idx = np.array([[4, 0, -1], [2, 2, 1]])     # 2-D plan with a negative entry
    for axis in (-1, 0):
        w, g = jlwe.lwe_take(cts[0], idx % 3 if axis == 0 else idx, axis), \
            lwe.lwe_take(mine[0], idx % 3 if axis == 0 else idx, axis)
        for f in ("a", "b", "cv"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))


def test_index_plans_are_cached_by_content():
    """The same plan maps to one tensor on the device, so a circuit's repeat
    stages make no new host-to-device copies."""
    p1 = lwe.plan_tensor(np.array([3, 1, 2]), "cpu")
    p2 = lwe.plan_tensor(np.array([3, 1, 2]), "cpu")
    assert p1 is p2 and p1.dtype == torch.int64
    assert lwe.plan_tensor(np.array([3, 1, 2], np.int32), "cpu").dtype == torch.int32


def test_noiseless_trivial_fills_on_device():
    """A Python or numpy scalar mu is filled on the requested device; an
    array is copied; both match tfhe_tpu."""
    for mu in (5, np.int32(-7), np.array([1, -2, 3], np.int32)):
        g = lwe.noiseless_trivial(mu, 4, (2, 3), device=torch.device("meta"))
        assert g.b.device.type == "meta" and g.a.shape == (2, 3, 4)
        g = lwe.noiseless_trivial(mu, 4, (2, 3), device="cpu")
        w = jlwe.noiseless_trivial(jnp.asarray(mu, jnp.int32), 4, (2, 3))
        for f in ("a", "b", "cv"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))


# ------------------------------------------------------------------ config, noise

def test_circuit_flags_match_tfhe_tpu():
    for env in ({}, {"TFHE_TPU_LOOKAHEAD": "1", "TFHE_TPU_SEPTET": "1",
                     "TFHE_TPU_NOISE_MODEL": "tracked"}):
        with config.overrides(**env), jconfig.overrides(**env):
            assert config.lookahead_enabled(1, 16) == jconfig.lookahead_enabled(1, 16)
            assert config.septet_enabled(16) == jconfig.septet_enabled(16)
            assert config.noise_model() == jconfig.noise_model()
    with config.overrides(TFHE_TPU_NOISE_MODEL="bogus"), pytest.raises(ValueError):
        config.noise_model()


@pytest.mark.parametrize("model", ["average", "measured", "tracked"])
def test_noise_helpers_match_tfhe_tpu(model):
    for p in (pt.PARAMS_110, pt.PARAMS_TOY, pt.PARAMS_SMALL_NOISY):
        with config.overrides(TFHE_TPU_NOISE_MODEL=model), \
                jconfig.overrides(TFHE_TPU_NOISE_MODEL=model):
            for name in ("var_modswitch", "var_ks_rounding", "sample_var_tracked",
                         "sample_var_average", "active_sample_var", "max_live16"):
                assert getattr(phasesim, name)(p) == getattr(jphasesim, name)(p), (name, p)
    assert phasesim.SAMPLE_VAR_MEASURED_110 == jphasesim.SAMPLE_VAR_MEASURED_110
