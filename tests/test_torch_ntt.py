"""tfhe_tpu_torch.ntt against tfhe_tpu.ntt: tables, transforms, CRT, polymul.

The same numpy inputs go through the JAX functions and the port's plain
torch functions; every output must be equal exactly (integer math)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import ntt as jntt
from tfhe_tpu import oracle
from tfhe_tpu.ops import cmux_pallas as jcp
from tfhe_tpu_torch import ntt
from tfhe_tpu_torch.ops import cmux

PRIMES = (ntt.P1, ntt.P2)


def _residues(rng, shape, p):
    return rng.randint(0, p, size=shape).astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("N", [128, 256, 1024])
@pytest.mark.parametrize("p", PRIMES)
def test_ntt_tables_match(N, p):
    want = jntt.ntt_tables(N, p)
    got = ntt.ntt_tables(N, p)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("N", [128, 256, 1024])
def test_twiddle_stack_matches_pallas_columns(N):
    """The kernels' twiddle table is the first five columns of the Pallas
    kernel's (the rest serve the TPU's roll-select butterflies only)."""
    want = jcp._twiddle_stack(N, 512)[:, :, :5]
    got = cmux._twiddle_stack(N, 512)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_crt_constants_match():
    for name in ("P1", "P2", "_INV_P1_MOD_P2", "_M_MOD_2_32", "_T_HALF", "_R1_HALF",
                 "_INV_P1_SHOUP"):
        assert getattr(ntt, name) == getattr(jntt, name), name


@pytest.mark.parametrize("N", [128, 1024])
@pytest.mark.parametrize("p", PRIMES)
def test_forward_inverse_match(N, p):
    rng = np.random.RandomState(N + p % 97)
    x = _residues(rng, (3, N), p)
    want_f = np.asarray(jntt.ntt_forward(jnp.asarray(x), N, p))
    got_f = ntt.ntt_forward(_t(x), N, p)
    np.testing.assert_array_equal(got_f.numpy(), want_f.astype(np.int64))
    want_i = np.asarray(jntt.ntt_inverse(jnp.asarray(x), N, p))
    got_i = ntt.ntt_inverse(_t(x), N, p)
    np.testing.assert_array_equal(got_i.numpy(), want_i.astype(np.int64))
    np.testing.assert_array_equal(ntt.ntt_inverse(got_f, N, p).numpy(), x.astype(np.int64))


@pytest.mark.parametrize("p", PRIMES)
def test_rows_match(p):
    N, L = 256, 5
    rng = np.random.RandomState(p % 101)
    x = _residues(rng, (2, N, L), p)
    want_f = np.asarray(jntt.ntt_forward_rows(jnp.asarray(x), N, p))
    np.testing.assert_array_equal(ntt.ntt_forward_rows(_t(x), N, p).numpy(), want_f)
    want_i = np.asarray(jntt.ntt_inverse_rows(jnp.asarray(x), N, p))
    np.testing.assert_array_equal(ntt.ntt_inverse_rows(_t(x), N, p).numpy(), want_i)


@pytest.mark.parametrize("p", PRIMES)
def test_forward_np_and_shoup_match(p):
    N = 256
    rng = np.random.RandomState(9)
    x = rng.randint(-(2 ** 31), 2 ** 31, size=(4, N)).astype(np.int32)
    want = jntt.ntt_forward_np(jntt.i32_to_residue_np(x, p), N, p)
    got = ntt.ntt_forward_np(ntt.i32_to_residue_np(x, p), N, p)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ntt.shoup(got, p), jntt.shoup(want, p))


def test_crt_matches():
    rng = np.random.RandomState(11)
    r1 = _residues(rng, (4096,), ntt.P1)
    r2 = _residues(rng, (4096,), ntt.P2)
    r1[:2], r2[:2] = [0, ntt.P1 - 1], [0, ntt.P2 - 1]
    want = np.asarray(jntt.crt_to_i32(jnp.asarray(r1), jnp.asarray(r2)))
    got = ntt.crt_to_i32(_t(r1), _t(r2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", [128, 1024])
def test_polymul_matches(N):
    rng = np.random.RandomState(N)
    a = rng.randint(-512, 512, size=(2, N)).astype(np.int32)
    b = rng.randint(-(2 ** 31), 2 ** 31, size=(2, N)).astype(np.int32)
    want = np.asarray(jntt.negacyclic_polymul_i32(jnp.asarray(a), jnp.asarray(b)))
    got = ntt.negacyclic_polymul_i32(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), oracle.negacyclic_polymul(a[0], b[0]))
