"""tfhe_tpu_torch.core.bootstrap and the plain kernel versions of
tfhe_tpu_torch.ops.cmux against tfhe_tpu, on the same numpy inputs.

The JAX Pallas kernels run in interpret mode, as their own tests run them on
the CPU. The CUDA kernels are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import gates as jgates
from tfhe_tpu.core import bootstrap as jbs
from tfhe_tpu.core import lwe as jlwe
from tfhe_tpu.core.crypt import encrypt_bits as j_encrypt_bits
from tfhe_tpu.ops import cmux_pallas as jcp
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _cloud(jsk, params):
    return keys.cloud_from_raw(params, jsk.bk_raw, jsk.ks_a, jsk.ks_b, "cpu")


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(_t(jct.a), _t(jct.b), _t(jct.cv))


def _random_bk(params, n, seed):
    rng = np.random.RandomState(seed)
    bk = np.stack([rng.randint(0, p, size=(n, params.kpl, params.k + 1, params.N))
                   .astype(np.uint32) for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    return keys.bk_rows_layout(bk), keys.bk_rows_layout(sh), bk, sh


def _rand_i32(rng, shape):
    return rng.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)


# ------------------------------------------------------------------ pieces

def test_negacyclic_rotate_matches():
    rng = np.random.RandomState(1)
    x = _rand_i32(rng, (7, 2, 128))
    amt = rng.randint(0, 256, size=7).astype(np.int32)
    amt[:2] = [0, 255]
    want = np.asarray(jbs.negacyclic_rotate(jnp.asarray(x), jnp.asarray(amt)))
    np.testing.assert_array_equal(bs.negacyclic_rotate(_t(x), _t(amt)).numpy(), want)


def test_gadget_decompose_matches():
    rng = np.random.RandomState(2)
    x = _rand_i32(rng, (5, 2, 128))
    want = np.asarray(jbs.gadget_decompose(jnp.asarray(x), pt.PARAMS_TOY))
    np.testing.assert_array_equal(bs.gadget_decompose(_t(x), pt.PARAMS_TOY).numpy(), want)


def test_extern_product_matches():
    params = pt.PARAMS_TOY
    _, _, bk, sh = _random_bk(params, 1, 3)
    rng = np.random.RandomState(4)
    dec = rng.randint(-512, 512, size=(6, params.kpl, params.N)).astype(np.int32)
    want = np.asarray(jbs.extern_product_ntt(jnp.asarray(dec), jnp.asarray(bk[0]),
                                             jnp.asarray(sh[0]), params))
    got = bs.extern_product_ntt(_t(dec), _t(bk[0]), _t(sh[0]), params)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_extract_and_ks_onehot_match():
    params = pt.PARAMS_TOY
    rng = np.random.RandomState(5)
    acc = _rand_i32(rng, (4, 2, params.N))
    wa, wb = jbs.sample_extract(jnp.asarray(acc), params)
    ga, gb = bs.sample_extract(_t(acc), params)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    w1, wn = jbs.ks_onehot(wa, params, with_nnz=True)
    g1, gn = bs.ks_onehot(ga, params, with_nnz=True)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


def test_key_switch_matches(small_keys):
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    rng = np.random.RandomState(6)
    a_ext = _rand_i32(rng, (5, params.n_extract))
    b_ext = _rand_i32(rng, (5,))
    cv = rng.rand(5).astype(np.float32)
    want = jbs.key_switch(jnp.asarray(a_ext), jnp.asarray(b_ext), small_keys.cloud.ks_table,
                          jnp.asarray(cv), small_keys.params)
    got = bs.key_switch(_t(a_ext), _t(b_ext), cloud.ks_table, _t(cv), params)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


def test_prepare_acc_matches(small_keys):
    params = pt.PARAMS_SMALL
    rng = np.random.RandomState(7)
    x = jlwe.LweCiphertext(jnp.asarray(_rand_i32(rng, (9, params.n))),
                           jnp.asarray(_rand_i32(rng, (9,))), jnp.zeros(9, jnp.float32))
    x = jlwe.LweCiphertext(x.a, x.b.at[0].set(0), x.cv)   # barb == 0 case
    wacc, wbara = jbs._prepare_acc(x, jnp.int32(jgates.MU), small_keys.cloud)
    gacc, gbara = bs._prepare_acc(_ct(x), pt.gates.MU, _cloud(small_keys, params))
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))
    np.testing.assert_array_equal(gbara.numpy(), np.asarray(wbara))


# ------------------------------------------------------- plain kernel twins

def test_cmux_delta_plain_matches_pallas():
    """K1 at PARAMS_TOY, B = 8."""
    params = pt.PARAMS_TOY
    rows, rows_sh, _, _ = _random_bk(params, 1, 8)
    rng = np.random.RandomState(9)
    dec_t = rng.randint(-512, 512, size=(params.kpl, params.N, 8)).astype(np.int32)
    want = np.asarray(jcp.cmux_delta(jnp.asarray(dec_t), jnp.asarray(rows[0]),
                                     jnp.asarray(rows_sh[0]), params, interpret=True))
    before = dict(cmux.LAUNCHES)
    got = cmux.cmux_delta(_t(dec_t), _t(rows[0]), _t(rows_sh[0]), params)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cmux.LAUNCHES == before     # CPU tensors take the plain version


def test_blind_rotate_step_plain_matches_pallas():
    """K2 at PARAMS_TOY, B = 8."""
    params = pt.PARAMS_TOY
    rows, rows_sh, _, _ = _random_bk(params, 1, 10)
    rng = np.random.RandomState(11)
    acc_t = _rand_i32(rng, (2, params.N, 8))
    bara = rng.randint(0, 2 * params.N, size=(1, 8)).astype(np.int32)
    want = np.asarray(jcp.blind_rotate_step(jnp.asarray(acc_t), jnp.asarray(bara),
                                            jnp.asarray(rows[0]), jnp.asarray(rows_sh[0]),
                                            params, interpret=True))
    got = cmux.blind_rotate_step(_t(acc_t), _t(bara), _t(rows[0]), _t(rows_sh[0]), params)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blind_rotate_fused_plain_matches_pallas(small_keys):
    """K3 at PARAMS_SMALL, B = 3, on real keys."""
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    rng = np.random.RandomState(12)
    acc_t = _rand_i32(rng, (2, params.N, 3))
    bara = rng.randint(0, 2 * params.N, size=(params.n, 3)).astype(np.int32)
    want = np.asarray(jcp.blind_rotate_fused(
        jnp.asarray(acc_t), jnp.asarray(bara), small_keys.cloud.bk_rows,
        small_keys.cloud.bk_rows_shoup, params, interpret=True))
    got = cmux.blind_rotate_fused(_t(acc_t), _t(bara), cloud.bk_rows, cloud.bk_rows_shoup,
                                  params)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the scan over the bk_ntt layout, as tfhe_tpu's XLA path runs it
    scan = bs.blind_rotate(_t(acc_t).permute(2, 0, 1), _t(bara).T, cloud.bk_ntt,
                           cloud.bk_ntt_shoup, params)
    np.testing.assert_array_equal(scan.permute(1, 2, 0).numpy(), want)


def test_blind_rotate_ks_fused_plain_matches_pallas(small_keys):
    """K4 at PARAMS_SMALL, B = 96: r and ext byte-identical."""
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    bits = np.random.RandomState(13).randint(0, 2, size=96)
    x = j_encrypt_bits(small_keys, bits, seed=14)
    acc, bara = jbs._prepare_acc(x, jnp.int32(jgates.MU), small_keys.cloud)
    acc_t, bara_t = np.asarray(acc).transpose(1, 2, 0), np.asarray(bara).T
    wr, wext = jcp.blind_rotate_ks_fused(
        jnp.asarray(acc_t), jnp.asarray(bara_t), small_keys.cloud.bk_rows,
        small_keys.cloud.bk_rows_shoup, jcp.lane_ks_table(small_keys.cloud), params,
        interpret=True)
    gr, gext = cmux.blind_rotate_ks_fused(_t(acc_t), _t(bara_t), cloud.bk_rows,
                                          cloud.bk_rows_shoup, cloud.ks_table_perm, params)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gext.numpy(), np.asarray(wext))


# ------------------------------------------------------------------ pipeline

@pytest.mark.parametrize("fuseks", ["0", "1"], ids=["split", "fused"])
def test_bootstrap_routes_match_tfhe_tpu(small_keys, fuseks):
    """Both routes of bootstrap() against tfhe_tpu's CPU default (split),
    PARAMS_SMALL, B = 96: a and b exact, cv to rtol 1e-6."""
    params = pt.PARAMS_SMALL
    cloud = _cloud(small_keys, params)
    bits = np.random.RandomState(15).randint(0, 2, size=96)
    x = j_encrypt_bits(small_keys, bits, seed=16)
    want = jbs.bootstrap(x, jnp.int32(jgates.MU), small_keys.cloud)
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        got = bs.bootstrap(_ct(x), pt.gates.MU, cloud)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


def test_bootstrap_woks_matches(toy_keys):
    params = pt.PARAMS_TOY
    bits = np.random.RandomState(17).randint(0, 2, size=5)
    x = j_encrypt_bits(toy_keys, bits, seed=18)
    wa, wb, wcv = jbs.bootstrap_woks(x, jnp.int32(jgates.MU), toy_keys.cloud)
    ga, gb, gcv = bs.bootstrap_woks(_ct(x), pt.gates.MU, _cloud(toy_keys, params))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_allclose(gcv.numpy(), np.asarray(wcv), rtol=1e-6)


def test_wrappers_reject_other_devices():
    """No fallback: tensors that are neither all on the CPU nor all on one
    CUDA device raise instead of taking some other path."""
    params = pt.PARAMS_TOY
    meta = torch.empty((2, params.N, 4), dtype=torch.int32, device="meta")
    bara = torch.empty((params.n, 4), dtype=torch.int32, device="meta")
    bk = torch.empty((params.n, 2, params.N, 8), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        cmux.blind_rotate_fused(meta, bara, bk, bk, params)
    with pytest.raises(ValueError):
        cmux.blind_rotate_fused(meta, torch.zeros((params.n, 4), dtype=torch.int32),
                                bk, bk, params)
