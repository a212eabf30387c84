"""The paired key switch on the CPU: a gate that sums two bootstraps before
one key switch (``gates.MUX``, ``gates.prefix_combine``) key-switches the
pairs inside the key switch (``cmux.keyswitch_ref`` with `pairs`, the plain
version of the kernels' paired mode) or sums the extracted samples before
``core.bootstrap.key_switch`` (the split route), and both give the same
words. Held at PARAMS_TOY and PARAMS_TOY_L3: the plain paired key switch
against the split route on random accumulators, the two gates under
TFHE_TPU_FUSEKS=1 (the fused route's plain versions) against
TFHE_TPU_FUSEKS=0, the counter ``PAIR_KS`` by route, the span's route, and a
paired batch above the bootstrap's cap, which goes in chunks of whole pairs."""
import numpy as np
import pytest
import torch
from torch.profiler import profile

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAMS = {"toy": pt.PARAMS_TOY, "toy_l3": pt.PARAMS_TOY_L3}
# gate -> the outputs beyond its pairs, in units of the pairs: B_in = (2 + that) * B
KINDS = {"mux": 0, "prefix": 1}


@pytest.fixture(scope="module")
def keysets():
    return {name: pt.keygen(p, seed=(31, 41, 59), device="cpu") for name, p in PARAMS.items()}


def _same(got: LweCiphertext, want: LweCiphertext) -> None:
    for f in ("a", "b", "cv"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("B", [1, 7, 16, 17, 33])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("pname", list(PARAMS))
def test_plain_paired_keyswitch_is_the_split_route(keysets, monkeypatch, pname, kind, B):
    """keyswitch_ref with pairs = B of 2B (MUX) or 3B (prefix) accumulators,
    finished as the fused route finishes, against bootstrap_pairs_split on
    the same accumulators' extracted samples: a, b word for word, cv equal."""
    sk = keysets[pname]
    params, cloud = sk.params, sk.cloud
    B_in = (2 + KINDS[kind]) * B
    rng = np.random.RandomState(B_in)
    acc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(2, params.N, B_in))
                           .astype(np.int32))
    r, ext = cmux.keyswitch_ref(acc, cloud.ks_table_perm, params, pairs=B, b_add=gates._1_8)
    assert r.shape[0] == ext.shape[1] == B_in - B
    got = bs.finish_fused_ks(r, ext, params, pairs=B)

    a_ext, b_ext = bs.sample_extract(acc.permute(2, 0, 1), params)
    cv = torch.full((B_in,), bs._bootstrap_variance(params), dtype=torch.float32)
    monkeypatch.setattr(bs, "bootstrap_woks", lambda x, mu, c: (a_ext, b_ext, cv))
    want = bs.bootstrap_pairs_split(_trivial(B_in, params), gates.MU, cloud, B, gates._1_8)
    _same(got, want)


def _trivial(B: int, params) -> LweCiphertext:
    return LweCiphertext(torch.zeros((B, params.n), dtype=torch.int32),
                         torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.float32))


def _bits(sk, shape, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, size=shape).astype(np.int32)
    return bits, pt.encrypt_bits(sk, bits, torch.Generator().manual_seed(seed), "cpu")


def _gate(kind, sk, shape, seed):
    """The gate's outputs on encrypted random bits, and their plaintext."""
    if kind == "mux":
        (a, ca), (b, cb), (c, cc) = (_bits(sk, shape, seed + i) for i in range(3))
        return (gates.MUX(ca, cb, cc, sk.cloud),), (np.where(a == 1, b, c),)
    (gh, cgh), (gl, cgl), (ph, cph), (pl, cpl) = (_bits(sk, shape, seed + i) for i in range(4))
    return gates.prefix_combine(cgh, cgl, cph, cpl, sk.cloud), (
        np.where(ph == 1, gl, gh), ph & pl)


@pytest.mark.parametrize("shape", [(1,), (17,), (3, 5)], ids=str)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("pname", list(PARAMS))
def test_gates_fused_route_equals_split_route(keysets, pname, kind, shape):
    """MUX and prefix_combine under TFHE_TPU_FUSEKS=1 (the paired key switch
    of the fused route, its plain versions on the CPU) against
    TFHE_TPU_FUSEKS=0 (the split route), word for word, and decrypted."""
    sk = keysets[pname]
    with config.overrides(TFHE_TPU_FUSEKS="1"):
        fused, want = _gate(kind, sk, shape, seed=sum(shape))
    with config.overrides(TFHE_TPU_FUSEKS="0"):
        split, _ = _gate(kind, sk, shape, seed=sum(shape))
    for f, s, w in zip(fused, split, want, strict=True):
        assert f.batch_shape == tuple(shape)
        _same(f, s)
        np.testing.assert_array_equal(pt.decrypt_bits(sk, f), w)


@pytest.mark.parametrize("kind", list(KINDS))
def test_pair_ks_counts_each_route(keysets, kind):
    """PAIR_KS counts a paired bootstrap where its route runs: "kernel" on the
    fused route, "split" elsewhere; profiling.reset_counters clears it."""
    sk = keysets["toy"]
    profiling.reset_counters()
    with config.overrides(TFHE_TPU_FUSEKS="1"):
        _gate(kind, sk, (3,), seed=1)
        _gate(kind, sk, (2,), seed=2)
    with config.overrides(TFHE_TPU_FUSEKS="0"):
        _gate(kind, sk, (3,), seed=3)
    assert bs.PAIR_KS == {"kernel": 2, "split": 1}
    profiling.reset_counters()
    assert bs.PAIR_KS == {"kernel": 0, "split": 0}


@pytest.mark.parametrize("kind", list(KINDS))
def test_paired_span_names_its_route(keysets, kind):
    """The span tfhe.bootstrap of a paired bootstrap on the fused route names
    its route with ``_pairs`` and carries the pairs."""
    sk = keysets["toy"]
    profiling.reset_spans()
    try:
        with config.overrides(TFHE_TPU_FUSEKS="1"), profile():
            _gate(kind, sk, (4,), seed=5)
        (boot,) = [r for r in profiling.spans() if r.name == "tfhe.bootstrap"]
    finally:
        profiling.reset_spans()
    assert boot.attrs == {"route": "k5_pairs", "form": "plain", "l": 2,
                          "batch": (2 + KINDS[kind]) * 4, "parts": 1, "pairs": 4}


@pytest.mark.parametrize("B", [3, 4, 6])
@pytest.mark.parametrize("kind", list(KINDS))
def test_paired_batch_above_the_cap_goes_in_chunks_of_pairs(keysets, monkeypatch, kind, B):
    """With the cap forced to 5, a paired batch of 2B or 3B > 5 samples keeps
    the fused route in chunks of whole pairs (2 pairs, 4 samples, a call),
    then the unpaired samples in chunks of 5, with the bits of the paired
    key switch in one call."""
    sk = keysets["toy"]
    with config.overrides(TFHE_TPU_FUSEKS="1"):
        whole, want = _gate(kind, sk, (B,), seed=B)
        profiling.reset_counters()
        monkeypatch.setattr(bs, "CPU_MAX_BATCH", 5)
        calls, fused_ks = [], bs._bootstrap_fused_ks

        def counted(x, mu, cloud, pairs=0, b_add=0):
            calls.append((x.b.shape[0], pairs))
            return fused_ks(x, mu, cloud, pairs, b_add)

        monkeypatch.setattr(bs, "_bootstrap_fused_ks", counted)
        parts, _ = _gate(kind, sk, (B,), seed=B)
    assert bs.PAIR_KS == {"kernel": 1, "split": 0}
    rest = KINDS[kind] * B
    assert calls == ([(4, 2)] * (B // 2) + [(2, 1)] * (B % 2)
                     + [(min(5, rest - s), 0) for s in range(0, rest, 5)])
    for p, w, v in zip(parts, whole, want, strict=True):
        _same(p, w)
        np.testing.assert_array_equal(pt.decrypt_bits(sk, p), v)


# ----------------------------- the kernels' paired index map, as numpy models

def _paired_words(acc: np.ndarray, P: int, b_add: int) -> np.ndarray:
    """The words the key-switch kernels read in paired mode (csrc/cmux.cu
    ks_word), on the accumulator int32[B_in][2][N] they take: output b points
    at sample P + b and, where b < P, adds the words P samples (P * 2N words)
    before; ks_finish_kernel adds b_add to b_ext there. Returned as the
    unpaired accumulator int32[2, N, B_in - P] those words make, b_add
    folded into its b_ext, for the unpaired models."""
    N, B_in = acc.shape[1], acc.shape[2]
    flat = np.ascontiguousarray(acc.transpose(2, 0, 1)).reshape(-1).view(np.uint32)
    out = np.empty((B_in - P, 2 * N), np.uint64)
    for b in range(B_in - P):
        a0 = (P + b) * 2 * N
        words = flat[a0:a0 + 2 * N].astype(np.uint64)
        if b < P:
            words = words + flat[a0 - P * 2 * N:a0 - P * 2 * N + 2 * N]
            words[N] += b_add
        out[b] = words % 2 ** 32
    return out.astype(np.uint32).view(np.int32).reshape(B_in - P, 2, N).transpose(1, 2, 0)


@pytest.mark.parametrize("P,B_in,split,arm", [(3, 6, 16, "gather"), (2, 6, 4, "gather"),
                                              (1, 2, 1, "gather"), (7, 26, 2, "mma")])
def test_kernels_paired_index_map_matches_keyswitch_ref(P, B_in, split, arm):
    """The gather and tensor-core arms' numpy models (test_torch_kernel_redesign)
    on the words the paired kernels read equal keyswitch_ref with pairs: MUX
    (B_in = 2P), prefix (3P), and 19 outputs over a full and a ragged warp
    tile of the tensor-core arm."""
    from test_torch_kernel_redesign import _gather_model, _ks_case, _mma_model
    params, acc, tks, C = _ks_case(64, 16, B_in, seed=B_in + P)
    model = _gather_model if arm == "gather" else _mma_model
    r, ext = model(_paired_words(acc, P, gates._1_8), tks, params, C, split)
    r0, ext0 = cmux.keyswitch_ref(torch.from_numpy(acc), torch.from_numpy(tks), params,
                                  pairs=P, b_add=gates._1_8)
    np.testing.assert_array_equal(r, r0.numpy())
    np.testing.assert_array_equal(ext, ext0.numpy())
