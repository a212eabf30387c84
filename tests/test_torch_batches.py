"""Large, irregular batches through the kernel wrappers, as far as the CPU
can check them: the launch and sample counters, the batch the kernels refuse,
the key switch's plan at batches of 10^4 to 10^5, and the batch sizes a
16-bit 8x8 matmul sends through ``core.bootstrap`` (counted with the
bootstrap replaced by a stand-in that keeps shapes: no cryptography runs)."""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, gates, linalg
from tfhe_tpu_torch.apps import linreg
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux, cmux_packed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_count_launch_and_reset():
    cmux.reset_launches()
    cmux.count_launch("blind_rotate_ks_fused", 69632)
    cmux.count_launch("keyswitch", 69632)
    cmux.count_launch("blind_rotate_ks_fused", 3)
    assert cmux.LAUNCHES["blind_rotate_ks_fused"] == 2 and cmux.LAUNCHES["keyswitch"] == 1
    assert cmux.SAMPLES["blind_rotate_ks_fused"] == 69635 and cmux.SAMPLES["keyswitch"] == 69632
    assert set(cmux.SAMPLES) == set(cmux.LAUNCHES)
    cmux.reset_launches()
    assert not any(cmux.LAUNCHES.values()) and not any(cmux.SAMPLES.values())


def test_cpu_tensors_count_nothing():
    """A bootstrap on CPU tensors takes the plain versions: no launch, no sample."""
    sk = pt.keygen(pt.PARAMS_TOY, seed=2, device="cpu")
    x = pt.encrypt_bits(sk, np.array([0, 1, 1]), torch.Generator().manual_seed(1), "cpu")
    cmux.reset_launches()
    gates.AND(x, x, sk.cloud)
    gates.MUX(x, x, x, sk.cloud)
    assert not any(cmux.LAUNCHES.values()) and not any(cmux.SAMPLES.values())


def test_max_batch():
    """The accumulator's words stay under 2^31; 272,000 samples (the opening
    AND batch of the 200 x 10 regression) are well inside."""
    assert cmux.max_batch(1024) == 1_048_575
    assert 2 * 1024 * (cmux.max_batch(1024) + 1) >= 2 ** 31 > 2 * 1024 * cmux.max_batch(1024)
    assert cmux.max_batch(64) == 65535 * cmux.KS_MMA_ROWS      # the key switch's grid rows
    cmux._check_batch(272_000, pt.PARAMS_110)
    cmux._check_batch(1, pt.PARAMS_110)
    for B in (0, cmux.max_batch(1024) + 1, 1 << 22):
        with pytest.raises(ValueError, match="batch of"):
            cmux._check_batch(B, pt.PARAMS_110)


@pytest.mark.parametrize("wrapper", ["blind_rotate_fused", "blind_rotate_ks_fused", "keyswitch",
                                     "blind_rotate_step", "cmux_delta",
                                     "blind_rotate_fused_packed", "blind_rotate_packed_ks_fused"])
def test_wrappers_check_the_batch(wrapper, monkeypatch):
    """Every wrapper's CUDA path passes its batch through _check_batch before
    it touches the card (here: tensors declared to be on the card, and a limit
    of 2 samples)."""
    params = pt.PARAMS_TOY
    mod = cmux_packed if "packed" in wrapper else cmux
    monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cmux, "max_batch", lambda N: 2)
    B, N, n = 3, params.N, params.n
    acc_t = torch.zeros((2, N, B), dtype=torch.int32)
    bara = torch.zeros((n, B), dtype=torch.int32)
    key = torch.zeros(1, dtype=torch.uint32)
    args = {
        "blind_rotate_fused": (acc_t, bara, key, key, params),
        "blind_rotate_ks_fused": (acc_t, bara, key, key, key, params),
        "keyswitch": (acc_t, key, params),
        "blind_rotate_step": (acc_t, bara[:1], key, key, params),
        "cmux_delta": (torch.zeros((params.kpl, N, B), dtype=torch.int32), key, key, params),
        "blind_rotate_fused_packed": (torch.zeros((2 * B, N // 128, 128), dtype=torch.int32),
                                      bara, key, key, params),
        "blind_rotate_packed_ks_fused": (acc_t, bara, key, key, key, params),
    }[wrapper]
    with pytest.raises(ValueError, match="batch of 3"):
        getattr(mod, wrapper)(*args)


@pytest.mark.parametrize("B", [17, 256, 4096, 69_632, 272_000, 1_048_575])
def test_keyswitch_plan_at_large_batches(B):
    """Above KS_GATHER_MAX the tensor-core arm; once the tiles outnumber
    KS_MMA_BLOCKS the coefficients are cut into one range, never into none,
    and the grid's rows stay inside the limit."""
    N, C = 1024, 512
    mma, split = cmux.keyswitch_plan(B, N, C)
    assert mma == 1 and split >= 1 and N % split == 0 and (N // split) % cmux.KS_MMA_STEP == 0
    if B >= 4096:
        assert split == 1
    assert -(-B // cmux.KS_MMA_ROWS) <= 65535


# ------------------------------------------------- batches a circuit sends

@pytest.fixture
def batches(monkeypatch):
    """Replaces the bootstrap by a stand-in that records each flat batch and
    returns samples of the right shapes; yields (cloud, list of batches)."""
    params = pt.PARAMS_TOY
    seen = []

    def bootstrap(x, mu, cloud):
        seen.append(x.b.shape[0])
        return x

    def bootstrap_woks(x, mu, cloud):
        seen.append(x.b.shape[0])
        B = x.b.shape[0]
        return (torch.zeros((B, params.N), dtype=torch.int32), x.b, x.cv)

    def key_switch(a_ext, b_ext, table, cv, p):
        return LweCiphertext(torch.zeros((b_ext.shape[0], p.n), dtype=torch.int32), b_ext, cv)

    monkeypatch.setattr(bs, "bootstrap", bootstrap)
    monkeypatch.setattr(bs, "bootstrap_woks", bootstrap_woks)
    monkeypatch.setattr(bs, "key_switch", key_switch)

    class Cloud:
        pass
    cloud = Cloud()
    cloud.params, cloud.ks_table = params, None
    return cloud, seen


def _zeros(shape, n=16):
    return LweCiphertext(torch.zeros(shape + (n,), dtype=torch.int32),
                         torch.zeros(shape, dtype=torch.int32),
                         torch.zeros(shape, dtype=torch.float32))


def _by_route(seen):
    k5 = sum(b for b in seen if bs.small_batch(b))
    return k5, sum(seen) - k5


def test_matmul_8x8_batches(batches):
    """A 16-bit 8x8 matmul opens with all 8*8*8*136 partial products in one
    batch, then walks down through both routes of small_batch(); Cannon's
    rounds send 8 batches of 8*8*136 and the same reduction."""
    cloud, seen = batches
    x = _zeros((8, 8, 16))
    linalg.matmul(x, x, cloud)
    assert seen[0] == 8 * 8 * 8 * 136 == 69_632 and max(seen) == seen[0]
    k5, k3 = _by_route(seen)
    assert k5 > 0 and k3 > 0
    assert all(1 <= b <= cmux.max_batch(1024) for b in seen)
    # the final ripple add: 15 full adders of 2 images on 64 numbers
    assert seen[-15:] == [128] * 15
    flat = list(seen)
    seen.clear()
    linalg.cannon_matmul(x, x, cloud)
    assert seen[:8] == [8 * 8 * 136] * 8
    assert seen[8:] == flat[1:]                  # the same pool, the same reduction
    assert sum(seen) == sum(flat)


def test_linreg_200x10_batches(batches):
    """The 200 rows x 10 attributes fits: the numerical one opens each inner
    product with 272,000 samples, the binary one sends MUX 2 x 32,000 through
    bootstrap_woks; both stay inside the kernels' batch limit."""
    cloud, seen = batches
    cx, cy = _zeros((10, 200, 16)), _zeros((10, 200, 16))
    linreg.linear_regression(cx, cy, cloud)
    assert seen.count(272_000) == 2 and max(seen) == 272_000
    assert max(seen) <= cmux.max_batch(1024)
    numerical = sum(seen)
    seen.clear()
    linreg.linear_regression_binary(_zeros((10, 200)), cy, cloud)
    assert seen[0] == 2 * 32_000 == max(seen)
    assert sum(seen) < numerical / 4
    assert all(_by_route(s)[i] > 0 for s in (seen,) for i in (0, 1))


# ------------------------------------------------- batches split in parts

@pytest.fixture(scope="module")
def toy_sk():
    return pt.keygen(pt.PARAMS_TOY, seed=7, device="cpu")


def _random_samples(params, B, seed):
    rng = np.random.RandomState(seed)
    return LweCiphertext(
        torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(B, params.n)).astype(np.int32)),
        torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=B).astype(np.int32)),
        torch.zeros(B, dtype=torch.float32))


@pytest.mark.parametrize("B", [7, 8, 20, 21])
@pytest.mark.parametrize("route", ["split", "fused", "woks", "per-sample mu"])
def test_forced_cap_gives_the_unchunked_bytes(toy_sk, monkeypatch, B, route):
    """With the cap forced to 7, a batch of B is bootstrapped in parts of 7
    and a remainder, and the result is the unchunked one, byte for byte."""
    x = _random_samples(toy_sk.params, B, seed=B)
    mu = gates.MU
    if route == "per-sample mu":
        mu = torch.from_numpy(np.where(np.arange(B) % 3, gates.MU, gates.MU16).astype(np.int32))
    fn = bs.bootstrap_woks if route == "woks" else bs.bootstrap
    with pt.config.overrides(TFHE_TPU_FUSEKS="1" if route == "fused" else "0"):
        whole = fn(x, mu, toy_sk.cloud)
        parts = []
        name = "_bootstrap_woks_whole" if route == "woks" else "_bootstrap_whole"
        inner = getattr(bs, name)
        monkeypatch.setattr(bs, name, lambda c, m, k: parts.append(c.b.shape[0]) or inner(c, m, k))
        monkeypatch.setattr(bs, "CPU_MAX_BATCH", 7)
        split = fn(x, mu, toy_sk.cloud)
    assert parts == [7] * (B // 7) + ([B % 7] if B % 7 else [])
    whole = whole if isinstance(whole, tuple) else (whole.a, whole.b, whole.cv)
    split = split if isinstance(split, tuple) else (split.a, split.b, split.cv)
    for w, s in zip(whole, split, strict=True):
        assert torch.equal(w, s)


def _key_bytes(params) -> int:
    """Bytes of a CloudKey's six tensors at `params` (core/keys.py)."""
    from tfhe_tpu_torch import ntt
    from tfhe_tpu_torch.core.keys import _pad_to
    bk = params.n * len(ntt.PRIMES) * params.kpl * (params.k + 1) * params.N * 4
    ks = params.n_extract * params.ks_t * (params.ks_base - 1) * 4 * _pad_to(params.n + 1, 128)
    return 4 * bk + 2 * ks


def test_cap_of_an_80gb_card(monkeypatch):
    """The cap derived for an H100 80GB (81,079 MiB) at PARAMS_110: the
    kernels' index limit, below what memory allows. It splits the opening AND
    of a 16-bit 32 x 32 matmul (32^3 x 136 = 4,456,448 samples) into four
    parts and a remainder, and leaves the largest batch of the cells (the
    regression's 272,000) whole (a stand-in bootstrap records the parts)."""
    params = pt.PARAMS_110
    cap = bs.memory_cap(81_079 * 2 ** 20, _key_bytes(params), params.N)
    assert cap == cmux.max_batch(params.N) == 1_048_575
    assert (81_079 * 2 ** 20 - _key_bytes(params)) // bs.PEAK_BYTES_PER_SAMPLE > cap
    assert bs.memory_cap(16 * 2 ** 30, _key_bytes(params), params.N) < cap   # a 16 GiB card
    seen = []

    def whole(x, mu, cloud):
        seen.append(x.b.shape[0])
        return x

    monkeypatch.setattr(bs, "_bootstrap_whole", whole)
    monkeypatch.setattr(bs, "batch_cap", lambda device, cloud: cap)
    first_and = 32 ** 3 * (16 * 17 // 2)
    x = _zeros((32 ** 3, 136), n=1)
    out = gates.gate2("AND", x, x, None)
    assert first_and == 4_456_448 and out.batch_shape == (32 ** 3, 136)
    assert seen == [cap] * 4 + [first_and - 4 * cap]
    seen.clear()
    gates.gate2("AND", *(_zeros((272_000,), n=1),) * 2, None)
    assert seen == [272_000]


def test_cap_is_read_once_per_card(monkeypatch):
    """On a card the cap comes from the device's total memory, read once
    (cached by card, keys and N), never from free memory at call time."""
    calls = []

    class Props:
        total_memory = 81_079 * 2 ** 20

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: calls.append(i) or Props())
    bs._card_cap.cache_clear()
    try:
        for _ in range(3):
            assert bs._card_cap(0, 10 ** 8, 1024) == cmux.max_batch(1024)
        assert calls == [0]
    finally:
        bs._card_cap.cache_clear()
