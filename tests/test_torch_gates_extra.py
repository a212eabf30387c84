"""The gate extras of tfhe_tpu_torch.gates against tfhe_tpu.gates and their
truth tables: MAJ, XOR3, full_adder, the +-1/16 compressor bits (MU16,
trivial16_zero, bootstrap_images, full_adder16) and prefix_combine, at
PARAMS_TOY on JAX-encrypted inputs. a and b exact, cv to rtol 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import gates as jg
from tfhe_tpu.core.lwe import lwe_concat as j_concat
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import gates
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext, lwe_concat
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _ct(jct) -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)) for v in (jct.a, jct.b, jct.cv)))


def _assert_same(got: LweCiphertext, want) -> None:
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def toy(toy_keys):
    """The JAX toy keys, the port's key set from the same raw keys, the 8
    combinations of three bits (twice, as a [4, 4] batch) encrypted by
    tfhe_tpu, and the same bits re-encoded at +-1/16 by tfhe_tpu."""
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b,
                            keys.cloud_from_raw(pt.PARAMS_TOY, toy_keys.bk_raw,
                                                toy_keys.ks_a, toy_keys.ks_b, "cpu"))
    bits = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)] * 2)
    cts = [jt.encrypt_bits(toy_keys, bits[:, i].reshape(4, 4), seed=50 + i) for i in range(3)]
    mu16 = np.full(16, jg.MU16, np.int32)
    c16 = [jg.bootstrap_images(c.reshape(16), mu16, toy_keys.cloud).reshape(4, 4) for c in cts]
    return toy_keys, psk, bits.reshape(4, 4, 3), cts, c16


def test_maj_xor3(toy):
    jsk, psk, bits, (x, y, z), _ = toy
    for jfn, fn, truth in ((jg.MAJ, gates.MAJ, (bits.sum(-1) >= 2)),
                           (jg.XOR3, gates.XOR3, bits.sum(-1) % 2)):
        got = fn(_ct(x), _ct(y), _ct(z), psk.cloud)
        _assert_same(got, jfn(x, y, z, jsk.cloud))
        assert got.batch_shape == (4, 4)
        np.testing.assert_array_equal(pt.decrypt_bits(psk, got), truth.astype(np.int32))


def test_full_adder(toy):
    jsk, psk, bits, (x, y, z), _ = toy
    ws, wc = jg.full_adder(x, y, z, jsk.cloud)
    gs, gc = gates.full_adder(_ct(x), _ct(y), _ct(z), psk.cloud)
    _assert_same(gs, ws)
    _assert_same(gc, wc)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gs), bits.sum(-1) % 2)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gc), (bits.sum(-1) >= 2).astype(np.int32))


def test_trivial16_zero_and_mu16(toy):
    jsk, psk, _, _, _ = toy
    assert gates.MU16 == jg.MU16
    _assert_same(gates.trivial16_zero(16, (2, 3), device="cpu"), jg.trivial16_zero(16, (2, 3)))


def test_bootstrap_images(toy):
    """Per-image output amplitudes, negative ones folding a NOT: the +-1/16
    re-encoding of the fixture is tfhe_tpu's, and a mixed-amplitude batch
    matches too."""
    jsk, psk, bits, cts, c16 = toy
    mu16 = np.full(16, gates.MU16, np.int32)
    for jc, jc16 in zip(cts, c16):
        got = gates.bootstrap_images(_ct(jc).reshape(16), mu16, psk.cloud)
        _assert_same(got, jc16.reshape(16))
    t = j_concat([cts[0].reshape(16), cts[1].reshape(16)])
    mu = np.concatenate([np.full(16, -gates.MU16), np.full(16, gates.MU)]).astype(np.int32)
    want = jg.bootstrap_images(t, mu, jsk.cloud)
    got = gates.bootstrap_images(_ct(t), mu, psk.cloud)
    _assert_same(got, want)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, got),
                                  np.concatenate([1 - bits[..., 0].ravel(), bits[..., 1].ravel()]))


@pytest.mark.parametrize("mu_sum", ["MU16", "MU"])
def test_full_adder16(toy, mu_sum):
    """The +-1/16 full adder, its sum emitted at +-1/16 or re-encoded to the
    standard +-1/8."""
    jsk, psk, bits, _, (x, y, z) = toy
    ms = getattr(gates, mu_sum)
    ws, wc = jg.full_adder16(x, y, z, jsk.cloud, mu_sum=ms)
    gs, gc = gates.full_adder16(_ct(x), _ct(y), _ct(z), psk.cloud, mu_sum=ms)
    _assert_same(gs, ws)
    _assert_same(gc, wc)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gs), bits.sum(-1) % 2)
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gc), (bits.sum(-1) >= 2).astype(np.int32))


def test_prefix_combine(toy):
    """(g, p) o (g', p'): g = MUX(p_hi, g_lo, g_hi) (which is g_hi | (p_hi &
    g_lo) whenever g and p are never both 1, as in an adder), p = p_hi & p_lo."""
    jsk, psk, bits, (x, y, z), _ = toy
    w = jt.encrypt_bits(jsk, bits[..., 0] ^ bits[..., 1], seed=60)
    wg, wp = jg.prefix_combine(x, y, z, w, jsk.cloud)
    gg, gp = gates.prefix_combine(_ct(x), _ct(y), _ct(z), _ct(w), psk.cloud)
    _assert_same(gg, wg)
    _assert_same(gp, wp)
    g_hi, g_lo, p_hi, p_lo = bits[..., 0], bits[..., 1], bits[..., 2], bits[..., 0] ^ bits[..., 1]
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gg), np.where(p_hi == 1, g_lo, g_hi))
    np.testing.assert_array_equal(pt.decrypt_bits(psk, gp), p_hi & p_lo)


def test_constant_fills_on_the_operand_device(toy):
    """CONSTANT of a scalar is a fill on the requested device; of an array, a
    copy there; both match tfhe_tpu."""
    meta = gates.CONSTANT(1, 16, (2, 3), device=torch.device("meta"))
    assert meta.b.device.type == "meta" and meta.a.shape == (2, 3, 16)
    for value in (0, 1, np.array([[1, 0, 1], [0, 0, 1]])):
        _assert_same(gates.CONSTANT(value, 16, (2, 3), device="cpu"),
                     jg.CONSTANT(jnp.asarray(value), 16, (2, 3)))
    both = lwe_concat([gates.CONSTANT(1, 16, (2,), device="cpu"),
                       gates.CONSTANT(0, 16, (2,), device="cpu")])
    np.testing.assert_array_equal(pt.decrypt_bits(toy[1], both), [1, 1, 0, 0])
