"""The CUDA kernels of tfhe_tpu_torch against their plain-torch versions, on
the card, and whole circuits captured as CUDA graphs (arith.circuit) against
their eager runs. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor tfhe_tpu, so it also runs where jax is not
installed; tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith, config, gates, ntt
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import lwe
from tfhe_tpu_torch.core.keys import bk_rows_layout
from tfhe_tpu_torch.ops import _build, cmux, cmux_packed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_bk(params, n, rng, device, layout="rows"):
    bk = np.stack([rng.randint(0, p, size=(n, params.kpl, params.k + 1, params.N))
                   .astype(np.uint32) for p in ntt.PRIMES], axis=1)
    sh = np.stack([ntt.shoup(bk[:, i], p) for i, p in enumerate(ntt.PRIMES)], axis=1)
    if layout == "rows":
        bk, sh = bk_rows_layout(bk), bk_rows_layout(sh)
    return torch.from_numpy(bk).to(device), torch.from_numpy(sh).to(device)


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
                             "blind_rotate_fused": 1, "blind_rotate_ks_fused": 1,
                             "blind_rotate_fused_packed": 0, "keyswitch": 1}


@pytest.mark.parametrize("params", [tt.PARAMS_TOY, tt.PARAMS_SMALL], ids=["toy", "small"])
@pytest.mark.parametrize("form", cmux.CMUX_FORMS[2], ids=str)
def test_forms_match_plain_at_ragged_batches(cuda, params, form):
    """Every form of the kernels that hold S samples a block (K1, K2, K3),
    forced, at batches that fill the last block (2 * S) and leave it short
    (1, S - 1, S + 1): byte-equal to the plain versions."""
    S = form[0]
    rng = np.random.RandomState(params.N + S)
    bk, sh = _random_bk(params, params.n, rng, cuda)
    for B in sorted({1, S - 1, S + 1, 2 * S} - {0}):
        dec_t = _i32(rng, (params.kpl, params.N, B), -params.halfBg, params.halfBg).to(cuda)
        acc_t = _i32(rng, (2, params.N, B)).to(cuda)
        bara = _i32(rng, (params.n, B), 0, 2 * params.N).to(cuda)
        pairs = [
            (cmux.cmux_delta(dec_t, bk[0], sh[0], params, form=form),
             cmux.cmux_delta_ref(dec_t, bk[0], sh[0], params)),
            (cmux.blind_rotate_step(acc_t, bara[:1], bk[0], sh[0], params, form=form),
             cmux.blind_rotate_step_ref(acc_t, bara[:1], bk[0], sh[0], params)),
            (cmux.blind_rotate_fused(acc_t, bara, bk, sh, params, form=form),
             cmux.blind_rotate_fused_ref(acc_t, bara, bk, sh, params)),
        ]
        torch.cuda.synchronize()
        for got, want in pairs:
            assert got.dtype == want.dtype and torch.equal(got, want), (form, B)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048])
def test_planned_form_at_every_ring_size(cuda, N):
    """The form blind_rotate_plan picks at each N the kernels take: its
    shared memory as the Python plan counts it, and K1 and K3 byte-equal to
    plain on a batch that leaves the last block short."""
    params = dataclasses.replace(tt.PARAMS_TOY, N=N, n=3)
    S, nbuf = cmux.blind_rotate_plan(N, 2)
    size = ctypes.c_int(0)
    _build.check(_build.library().tfhe_cmux_smem_bytes(N, 2, S, nbuf, ctypes.byref(size)))
    assert size.value == cmux.cmux_smem_bytes(N, S, nbuf, 2) <= cmux.SMEM_MAX
    rng = np.random.RandomState(N)
    bk, sh = _random_bk(params, params.n, rng, cuda)
    dec_t = _i32(rng, (params.kpl, N, 5), -params.halfBg, params.halfBg).to(cuda)
    acc_t = _i32(rng, (2, N, 5)).to(cuda)
    bara = _i32(rng, (params.n, 5), 0, 2 * N).to(cuda)
    assert torch.equal(cmux.cmux_delta(dec_t, bk[0], sh[0], params),
                       cmux.cmux_delta_ref(dec_t, bk[0], sh[0], params))
    assert torch.equal(cmux.blind_rotate_fused(acc_t, bara, bk, sh, params),
                       cmux.blind_rotate_fused_ref(acc_t, bara, bk, sh, params))


def test_a_form_that_does_not_fit_is_refused(cuda):
    """Two samples with a double key buffer do not fit a block at N = 2048:
    the entry point reports an error and the wrapper raises."""
    params = dataclasses.replace(tt.PARAMS_TOY, N=2048, n=1)
    rng = np.random.RandomState(1)
    bk, sh = _random_bk(params, 1, rng, cuda)
    acc_t = _i32(rng, (2, 2048, 2)).to(cuda)
    bara = _i32(rng, (1, 2), 0, 4096).to(cuda)
    with pytest.raises(RuntimeError, match="CUDA kernel launch failed"):
        cmux.blind_rotate_fused(acc_t, bara, bk, sh, params, form=(2, 2))


def _ks_inputs(params, B, rng, kind, device):
    """A rotated accumulator int32[2, N, B] and a random limb table; `kind`
    "zero" makes every digit of every coefficient zero, "full" none."""
    N = params.N
    acc = rng.randint(-2 ** 31, 2 ** 31, size=(2, N, B)).astype(np.int64)
    if kind == "zero":
        acc[0] = params.ks_prec_offset
        acc[0, 0] = -params.ks_prec_offset
    elif kind == "full":
        digs = rng.randint(1, 4, size=(N, B, params.ks_t))
        u = sum(digs[..., j].astype(np.int64) << (32 - (j + 1) * params.ks_basebit)
                for j in range(params.ks_t)) + 1
        x = u - params.ks_prec_offset
        x[1:] = -x[1:]
        acc[0] = (x + 2 ** 31) % 2 ** 32 - 2 ** 31
    C = -(-(params.n + 1) // 128) * 128
    tks = rng.randint(-128, 128, size=(params.ks_t * (params.ks_base - 1), N, 4 * C))
    return (torch.from_numpy(acc.astype(np.int32)).to(device),
            torch.from_numpy(tks.astype(np.int8)).to(device))


@pytest.mark.parametrize("params", [tt.PARAMS_SMALL, tt.PARAMS_110], ids=["small", "110"])
@pytest.mark.parametrize("B", [1, 2, 3, 33, 64, 256])
def test_keyswitch_matches_plain(cuda, params, B):
    """The key-switch kernel byte-equal to keyswitch_ref: the arm the plan
    takes at this B, then both arms forced, on random digits, on all-zero
    digits and on all-nonzero digits."""
    rng = np.random.RandomState(B)
    for kind in ("random", "zero", "full"):
        acc_t, tks = _ks_inputs(params, B, rng, kind, cuda)
        want = cmux.keyswitch_ref(acc_t, tks, params)
        cmux.reset_launches()
        got = [cmux.keyswitch(acc_t, tks, params)]
        acc = cmux._acc_rows(acc_t, params)
        for plan in ((0, 8), (1, 2)):      # (arm, ranges of N): gather, tensor cores
            got.append(cmux._launch_keyswitch(acc, tks, params, plan=plan))
        torch.cuda.synchronize()
        assert cmux.LAUNCHES["keyswitch"] == 3
        for r, ext in got:
            assert torch.equal(r, want[0]) and torch.equal(ext, want[1]), kind
        if kind != "random":
            assert (want[1][1] == (0 if kind == "zero" else params.N * params.ks_t)).all()


@pytest.mark.parametrize("params", [tt.PARAMS_SMALL, tt.PARAMS_110], ids=["small", "110"])
@pytest.mark.parametrize("B", [1, 2, 3, 30, 31, 64, 66, 67, 132, 133, 256, "max", "max+1"])
def test_k5_matches_plain(cuda, params, B):
    """K5, alone and chained with the key switch, byte-equal to its plain
    versions, each launch counted; n is cut to 4 steps at PARAMS_110. "max" is
    the largest batch the bootstrap routes to K5."""
    if isinstance(B, str):
        B = bs.WAVES[params.bk_l].small_batch_max + (B == "max+1")
    rng = np.random.RandomState(B)
    n = min(params.n, 4 if params.N == 1024 else params.n)
    bk, sh = _random_bk(params, n, rng, cuda, layout="ntt")
    acc_t = _i32(rng, (2, params.N, B)).to(cuda)
    acc_p = acc_t.permute(0, 2, 1).reshape(2 * B, params.N // 128, 128)
    bara = _i32(rng, (n, B), 0, 2 * params.N).to(cuda)
    C = -(-(params.n + 1) // 128) * 128
    tks = torch.from_numpy(rng.randint(-128, 128, size=(24, params.N, 4 * C))
                           .astype(np.int8)).to(cuda)
    cmux.reset_launches()
    got = cmux_packed.blind_rotate_fused_packed(acc_p, bara, bk, sh, params)
    r, ext = cmux_packed.blind_rotate_packed_ks_fused(acc_t, bara, bk, sh, tks, params)
    want = cmux_packed.blind_rotate_fused_packed_ref(acc_p, bara, bk, sh, params)
    r2, ext2 = cmux_packed.blind_rotate_packed_ks_fused_ref(acc_t, bara, bk, sh, tks, params)
    torch.cuda.synchronize()
    for g, w in ((got, want), (r, r2), (ext, ext2)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert cmux.LAUNCHES["blind_rotate_fused_packed"] == 2
    assert cmux.LAUNCHES["keyswitch"] == 1


def test_small_cluster_follows_what_the_card_holds(cuda):
    """A batch that fits one wave of 4-CTA clusters gets them, a larger one
    clusters of 2, of which the card holds more at once."""
    N, dev = tt.PARAMS_110.N, torch.cuda.current_device()
    four, two = (cmux_packed.samples_in_flight(N, c, dev, 2) for c in (4, 2))
    assert 1 <= four < two
    assert cmux_packed.small_cluster(1, N, cuda, 2) == 4
    assert cmux_packed.small_cluster(four, N, cuda, 2) == 4
    assert cmux_packed.small_cluster(four + 1, N, cuda, 2) == 2
    assert cmux_packed.small_cluster(two + 1, N, cuda, 2) == 2


@pytest.mark.parametrize("arm", ["0", "1"])
def test_circuits_on_card_match_cpu(cuda, arm):
    """The integer circuits on the card give the very samples of the CPU
    plain path: PARAMS_SMALL, 4-bit operands, batch 2, in each arm of the
    adders (TFHE_TPU_LOOKAHEAD forced on both sides: by default the card
    picks its arm by its cost a stage, the CPU ripple)."""
    sk = tt.keygen(tt.PARAMS_SMALL, seed=4, device=cuda)
    cpu_cloud = sk.cloud.to("cpu")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    a, b = np.array([5, -3]), np.array([-2, 3])
    x, y, px, py = (arith.encrypt_int(sk, v, 4, gen, cuda)
                    for v in (a, b, np.abs(a), np.abs(b)))
    cases = [(arith.add, (x, y)), (arith.sub, (x, y)), (arith.mul, (x, y)),
             (arith.gt, (x, y)), (arith.eq, (x, y)), (arith.absolute, (x,)),
             (arith.minimum, (px, py)), (arith.div, (x, y))]
    with config.overrides(TFHE_TPU_LOOKAHEAD=arm):
        for fn, args in cases:
            got = fn(*args, sk.cloud)
            want = fn(*[v.to("cpu") for v in args], cpu_cloud)
            assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b), fn
        np.testing.assert_array_equal(arith.decrypt_int(sk, arith.div(x, y, sk.cloud)), [-2, -1])


def test_adder_arm_on_the_card(cuda):
    """On the card the adders take prefix for one 16-bit number and ripple
    for 64, counted in ADDER_ARMS, and both decrypt right."""
    sk = tt.keygen(tt.PARAMS_110, seed=14, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    for numbers, arm in ((1, "prefix"), (64, "ripple")):
        a, b = (np.arange(numbers) * k - 3000 for k in (37, -11))
        x, y = (arith.encrypt_int(sk, v, 16, gen, cuda) for v in (a, b))
        before = dict(arith.ADDER_ARMS)
        with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
            out = arith.add(x, y, sk.cloud)
        assert arith.ADDER_ARMS[arm] == before[arm] + 1
        np.testing.assert_array_equal(arith.decrypt_int(sk, out), a + b)


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


# ------------------------------------------------------------------ circuit graphs

@pytest.fixture(scope="module")
def small_sk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tt.keygen(tt.PARAMS_SMALL, seed=11, device="cuda")


# name -> (call, operands: "ab" signed, "pq" positive, plaintext answer)
GRAPH_CIRCUITS = {
    "add": (lambda x, y, c: arith.add(x, y, c), "ab", lambda a, b: a + b),
    "sub": (lambda x, y, c: arith.sub(x, y, c), "ab", lambda a, b: a - b),
    "mul": (lambda x, y, c: arith.mul(x, y, c), "ab", lambda a, b: a * b),
    "mul_plain": (lambda x, y, c: arith.mul_plain(x, 5, c), "ab", lambda a, b: 5 * a),
    "mul_full": (lambda x, y, c: arith.mul_full(x, y, c, 6), "pq", lambda a, b: a * b),
    "gt": (lambda x, y, c: arith.gt(x, y, c), "ab", lambda a, b: (a > b).astype(np.int64)),
    "eq": (lambda x, y, c: arith.eq(x, y, c), "ab", lambda a, b: (a == b).astype(np.int64)),
    "absolute": (lambda x, y, c: arith.absolute(x, c), "ab", lambda a, b: np.abs(a)),
    "minimum": (lambda x, y, c: arith.minimum(x, y, c), "pq", np.minimum),
    "div": (lambda x, y, c: arith.div(x, y, c), "ab", lambda a, b: np.trunc(a / b).astype(np.int64)),
}


def _operands(sk, kind: str, seed: int):
    """Two 4-bit operand batches of 3 numbers (signed, or positive) and their values."""
    rng = np.random.RandomState(seed)
    a, b = (rng.randint(-7, 8, 3) for _ in range(2))
    b = np.where(b == 0, 3, b)
    if kind == "pq":
        a, b = np.abs(a), np.abs(b)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (a, b), tuple(arith.encrypt_int(sk, v, 4, gen, "cuda") for v in (a, b))


def _decrypt(sk, ct, nbits: int):
    """An integer result mod 2^nbits, or a comparison's bits."""
    if ct.batch_shape[-1:] == (nbits,):
        return arith.decrypt_int(sk, ct, signed=False)
    return tt.decrypt_bits(sk, ct)


def _same(got, want) -> bool:
    return all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("a", "b", "cv"))


@pytest.mark.parametrize("name", list(GRAPH_CIRCUITS))
def test_captured_circuit_equals_eager(small_sk, name, monkeypatch):
    """At PARAMS_SMALL: the captured circuit equals the eager one (a, b and
    cv exact), replays on other operands give their own right results, two
    results share no tensor, and the counters after a replay equal eager's."""
    sk = small_sk
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    call, kind, truth = GRAPH_CIRCUITS[name]
    (va, vb), xs = _operands(sk, kind, 1)
    (wa, wb), ys = _operands(sk, kind, 2)
    width = 6 if name == "mul_full" else 4
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        eager_x = call(*xs, sk.cloud)
        cmux.reset_launches()
        eager_y = call(*ys, sk.cloud)
        torch.cuda.synchronize()
        eager_counts = (dict(cmux.LAUNCHES), dict(cmux.SAMPLES))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        call(*xs, sk.cloud)                                    # the warm-up
        assert arith.GRAPHS.graphs() == 0
        captured = call(*xs, sk.cloud)
        assert arith.GRAPHS.graphs() == 1
        cmux.reset_launches()
        replayed = call(*ys, sk.cloud)
        torch.cuda.synchronize()
        assert (dict(cmux.LAUNCHES), dict(cmux.SAMPLES)) == eager_counts
        again = call(*xs, sk.cloud)
    torch.cuda.synchronize()
    assert _same(captured, eager_x) and _same(again, eager_x) and _same(replayed, eager_y)
    assert len({t.a.data_ptr() for t in (captured, replayed, again)}) == 3
    np.testing.assert_array_equal(_decrypt(sk, replayed, width),
                                  truth(wa, wb) & ((1 << width) - 1))


def test_evicted_plan_tensor_cannot_corrupt_a_graph(small_sk, monkeypatch):
    """A plan cache just large enough for one multiply: once the graph is
    captured, other plans evict all of the multiply's and fresh tensors take
    their memory; the graph's replays still equal the eager multiply, since it
    holds the plans it read (core/lwe.keeping)."""
    sk = small_sk
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    plain = lwe._plan_tensor.__wrapped__
    counting = functools.lru_cache(maxsize=None)(plain)
    monkeypatch.setattr(lwe, "_plan_tensor", counting)
    _, xs = _operands(sk, "ab", 3)
    _, ys = _operands(sk, "ab", 4)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        arith.mul(*xs, sk.cloud)                               # the warm-up
        plans = counting.cache_info().currsize
        tiny = functools.lru_cache(maxsize=plans)(plain)
        monkeypatch.setattr(lwe, "_plan_tensor", tiny)
        with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
            arith.mul(*xs, sk.cloud)                           # fills the tiny cache
        arith.mul(*xs, sk.cloud)                               # captures
        assert arith.GRAPHS.graphs() == 1 and tiny.cache_info().misses == plans
        for i in range(2 * plans):
            lwe.plan_tensor(np.arange(i, i + 40, dtype=np.int64), "cuda")
        assert tiny.cache_info().misses == 3 * plans
        junk = [torch.full((s,), -1, dtype=torch.int64, device="cuda")
                for s in range(1, 4096, 7)]
        replayed = arith.mul(*ys, sk.cloud)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        eager = arith.mul(*ys, sk.cloud)
    torch.cuda.synchronize()
    assert junk and _same(replayed, eager)


def test_plan_evicted_before_the_capture_is_still_captured(small_sk, monkeypatch):
    """A plan cache of 8 entries, emptied of the multiply's plans between its
    warm-up and its capture: the capture reads the warm-up's plans
    (core/lwe.keeping), so it copies nothing from the host, and the captured
    and replayed results equal the eager multiply's."""
    sk = small_sk
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    tiny = functools.lru_cache(maxsize=8)(lwe._plan_tensor.__wrapped__)
    monkeypatch.setattr(lwe, "_plan_tensor", tiny)
    _, xs = _operands(sk, "ab", 5)
    _, ys = _operands(sk, "ab", 6)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        arith.mul(*xs, sk.cloud)                               # the warm-up
        for i in range(16):
            lwe.plan_tensor(np.arange(i, i + 40, dtype=np.int64), "cuda")
        misses = tiny.cache_info().misses
        captured = arith.mul(*xs, sk.cloud)
        assert arith.GRAPHS.graphs() == 1 and tiny.cache_info().misses == misses
        replayed = arith.mul(*ys, sk.cloud)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        eager_x, eager_y = arith.mul(*xs, sk.cloud), arith.mul(*ys, sk.cloud)
    torch.cuda.synchronize()
    assert _same(captured, eager_x) and _same(replayed, eager_y)


# ---------------------------------------------------------------- four cards

NCCL_WORLD = 4


def _nccl_and_rank(rank, world, device, bits):
    """One rank of the NCCL test: keys and inputs made on this card from one
    seed (the same on every card), the sharded AND over the world, and this
    card's one-process AND of the same inputs."""
    import torch.distributed as dist
    from tfhe_tpu_torch.parallel.mesh import make_mesh, sharded_gate2
    sk = tt.keygen(tt.PARAMS_SMALL, seed=(8, 4, 4), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(44)
    x, y = (tt.encrypt_bits(sk, b, gen, device) for b in bits)
    out = sharded_gate2("AND", x, y, sk.cloud, make_mesh(world, device=device))
    one = gates.AND(x, y, sk.cloud)
    return {"backend": dist.get_backend(), "device": str(device),
            "out": tuple(v.cpu().numpy() for v in (out.a, out.b, out.cv)),
            "one": tuple(v.cpu().numpy() for v in (one.a, one.b, one.cv)),
            "bits": tt.decrypt_bits(sk, out)}


def test_dp_and_over_nccl_on_four_cards(cuda):
    """DP AND at world 4 with one rank a card: every rank runs NCCL on
    cuda:rank, returns the same bytes, equal to its card's one-process AND
    (a, b exact, cv to rtol 1e-6), decrypting to a & b."""
    if torch.cuda.device_count() < NCCL_WORLD:
        pytest.skip(f"needs {NCCL_WORLD} cards, one a rank")
    from tfhe_tpu_torch.parallel import dryrun
    bits = np.random.RandomState(4).randint(0, 2, size=(2, 16 * NCCL_WORLD)).astype(np.int32)
    outs = dryrun.run(NCCL_WORLD, _nccl_and_rank, bits)
    for r, o in enumerate(outs):
        assert (o["backend"], o["device"]) == ("nccl", f"cuda:{r}")
        for got, want in zip(o["out"], outs[0]["out"]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(o["out"][0], o["one"][0])
        np.testing.assert_array_equal(o["out"][1], o["one"][1])
        np.testing.assert_allclose(o["out"][2], o["one"][2], rtol=1e-6)
        np.testing.assert_array_equal(o["bits"], bits[0] & bits[1])
