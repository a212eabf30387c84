"""The CUDA kernels of tfhe_tpu_torch against their plain-torch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor tfhe_tpu, so it also runs where jax is not
installed; tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import config, gates, ntt
from tfhe_tpu_torch.core.keys import bk_rows_layout
from tfhe_tpu_torch.ops import cmux

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_bk(params, n, rng, device):
    bk = np.stack([rng.randint(0, p, size=(n, params.kpl, params.k + 1, params.N))
                   .astype(np.uint32) for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    return (torch.from_numpy(bk_rows_layout(bk)).to(device),
            torch.from_numpy(bk_rows_layout(sh)).to(device))


def _i32(rng, shape, lo=-2 ** 31, hi=2 ** 31):
    return torch.from_numpy(rng.randint(lo, hi, size=shape).astype(np.int32))


@pytest.mark.parametrize("params", [tt.PARAMS_TOY, tt.PARAMS_SMALL, tt.PARAMS_110],
                         ids=["toy", "small", "110"])
def test_kernels_match_plain(cuda, params):
    """K1, K2, K3 and K4 byte-equal to their plain versions, and each launch
    counted; n is cut to 4 steps at PARAMS_110."""
    rng = np.random.RandomState(params.N)
    n, B = min(params.n, 4 if params.N == 1024 else params.n), 5
    bk, sh = _random_bk(params, n, rng, cuda)
    dec_t = _i32(rng, (params.kpl, params.N, B), -params.halfBg, params.halfBg).to(cuda)
    acc_t = _i32(rng, (2, params.N, B)).to(cuda)
    bara = _i32(rng, (n, B), 0, 2 * params.N).to(cuda)
    C = -(-(params.n + 1) // 128) * 128
    tks = torch.from_numpy(rng.randint(-128, 128, size=(24, params.N, 4 * C))
                           .astype(np.int8)).to(cuda)
    cmux.reset_launches()
    pairs = [
        (cmux.cmux_delta(dec_t, bk[0], sh[0], params),
         cmux.cmux_delta_ref(dec_t, bk[0], sh[0], params)),
        (cmux.blind_rotate_step(acc_t, bara[:1], bk[0], sh[0], params),
         cmux.blind_rotate_step_ref(acc_t, bara[:1], bk[0], sh[0], params)),
        (cmux.blind_rotate_fused(acc_t, bara, bk, sh, params),
         cmux.blind_rotate_fused_ref(acc_t, bara, bk, sh, params)),
    ]
    r, ext = cmux.blind_rotate_ks_fused(acc_t, bara, bk, sh, tks, params)
    r2, ext2 = cmux.blind_rotate_ks_fused_ref(acc_t, bara, bk, sh, tks, params)
    torch.cuda.synchronize()
    for got, want in pairs + [(r, r2), (ext, ext2)]:
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert cmux.LAUNCHES == {"cmux_delta": 1, "blind_rotate_step": 1,
                             "blind_rotate_fused": 1, "blind_rotate_ks_fused": 1}


@pytest.mark.parametrize("B", [1, 3, 64])
def test_gates_on_card_match_cpu(cuda, B):
    """Keys made on the card; every two-input gate, both routes and MUX give
    on the card the very samples the CPU plain path gives."""
    sk = tt.keygen(tt.PARAMS_TOY, seed=B, device=cuda)
    cpu_cloud = sk.cloud.to("cpu")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B)
    rng = np.random.RandomState(B)
    bits = [rng.randint(0, 2, B) for _ in range(3)]
    x, y, z = (tt.encrypt_bits(sk, v, gen, cuda) for v in bits)
    for name in gates.GATE_TABLE:
        for fuse in ("0", "1"):
            with config.overrides(TFHE_TPU_FUSEKS=fuse):
                got = gates.gate2(name, x, y, sk.cloud)
                want = gates.gate2(name, x.to("cpu"), y.to("cpu"), cpu_cloud)
            assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)
    got = gates.MUX(x, y, z, sk.cloud)
    want = gates.MUX(x.to("cpu"), y.to("cpu"), z.to("cpu"), cpu_cloud)
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)
    np.testing.assert_array_equal(tt.decrypt_bits(sk, got),
                                  np.where(bits[0] == 1, bits[1], bits[2]))


def test_wrapper_rejects_bad_input_on_card(cuda):
    params = tt.PARAMS_TOY
    rng = np.random.RandomState(1)
    bk, sh = _random_bk(params, 2, rng, cuda)
    acc_t = _i32(rng, (2, params.N, 3)).to(cuda)
    bara = _i32(rng, (2, 3), 0, 2 * params.N).to(cuda)
    with pytest.raises(ValueError):                    # bara of another batch
        cmux.blind_rotate_fused(acc_t, bara[:, :2], bk, sh, params)
    with pytest.raises(ValueError):                    # key as int32, not uint32
        cmux.blind_rotate_fused(acc_t, bara, bk.view(torch.int32), sh, params)
    with pytest.raises(ValueError):                    # mixed devices
        cmux.blind_rotate_fused(acc_t, bara.cpu(), bk, sh, params)
