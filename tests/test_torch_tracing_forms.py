"""The gadget length and the form of a blind rotate on the program's spans,
and ``ops.cmux.FORM_SAMPLES``, held on the CPU at PARAMS_TOY_L3 (l = 3) and
PARAMS_TOY (l = 2).

Under ``torch.profiler.profile`` the span ``tfhe.bootstrap`` names the
gadget length ``l`` and the ``form`` of its route ("plain" on the CPU); the
CUDA branch of a blind-rotate wrapper (reached with the library stood in for,
as tests/test_torch_tracing.py does) names the form it launched: "S/nbuf"
for K3/K4, "c4" or "c2" for K5, and adds its batch to FORM_SAMPLES under
(launch name, l, S, nbuf). A circuit captured as a graph (``arith.circuit``,
through a recording stand-in) adds the samples of its capture on every
replay, as it adds ``SAMPLES``."""
import numpy as np
import pytest
import torch
from torch.profiler import profile

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _keys(P, seed):
    sk = pt.keygen(P, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = pt.encrypt_bits(sk, np.array([0, 1, 1, 0], np.int32), g, "cpu")
    y = pt.encrypt_bits(sk, np.array([0, 0, 1, 1], np.int32), g, "cpu")
    return sk, x, y


@pytest.fixture(scope="module")
def toy_l3():
    return _keys(pt.PARAMS_TOY_L3, 21)


@pytest.fixture(scope="module")
def toy_l2():
    return _keys(pt.PARAMS_TOY, 22)


@pytest.fixture(autouse=True)
def empty():
    profiling.reset_spans()
    cmux.reset_launches()
    yield
    profiling.reset_spans()
    cmux.reset_launches()


@pytest.mark.parametrize("fuseks", ["0", "1"])
def test_bootstrap_span_names_the_gadget_and_the_plain_form(toy_l3, fuseks):
    sk, x, y = toy_l3
    with config.overrides(TFHE_TPU_FUSEKS=fuseks), profile():
        out = gates.gate2("AND", x, y, sk.cloud)
    assert pt.decrypt_bits(sk, out).tolist() == [0, 0, 1, 0]
    (boot,) = [r for r in profiling.spans() if r.name == "tfhe.bootstrap"]
    assert boot.attrs["l"] == 3 and boot.attrs["form"] == "plain"
    assert cmux.FORM_SAMPLES == {}              # the plain route launches nothing


class _Library:
    """Stands in for the CUDA library: every entry point returns success."""
    def __getattr__(self, name):
        return lambda *args: 0


# (fused key switch, small batch, cluster) -> (wrapper span, launch name, form,
# FORM_SAMPLES form (S, nbuf)) at l = 3 and at l = 2
CASES = {
    ("1", False, 2): ("blind_rotate_ks_fused", "blind_rotate_ks_fused",
                      {3: ("2/1", (2, 1)), 2: ("2/2", (2, 2))}),
    ("0", False, 2): ("blind_rotate_fused", "blind_rotate_fused",
                      {3: ("2/1", (2, 1)), 2: ("2/2", (2, 2))}),
    ("1", True, 4): ("blind_rotate_packed_ks_fused", "blind_rotate_fused_packed",
                     {3: ("c4", (1, 2)), 2: ("c4", (1, 2))}),
    ("0", True, 2): ("blind_rotate_fused_packed", "blind_rotate_fused_packed",
                     {3: ("c2", (1, 0)), 2: ("c2", (1, 0))}),
}


@pytest.mark.parametrize("l", [3, 2])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_wrapper_spans_and_form_samples(toy_l3, toy_l2, monkeypatch, l, case):
    sk, x, y = toy_l3 if l == 3 else toy_l2
    fuseks, small, cluster = case
    wrapper, launch, forms = CASES[case]
    form, key = forms[l]
    for mod in (cmux, cmux_packed):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "library", _Library)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(cmux_packed, "small_cluster", lambda B, N, device, l: cluster)
    monkeypatch.setattr(bs, "small_batch", lambda B, params=None: small)
    with config.overrides(TFHE_TPU_FUSEKS=fuseks), profile():
        gates.gate2("AND", x, y, sk.cloud)
    (k,) = [r for r in profiling.spans() if r.name == f"tfhe.kernel.{wrapper}"]
    assert k.attrs == {"batch": 4, "l": l, "form": form}
    assert cmux.FORM_SAMPLES == {(launch, l) + key: 4}
    cmux.count_launch(launch, 6, (l,) + key)
    assert cmux.FORM_SAMPLES == {(launch, l) + key: 10}
    assert cmux.SAMPLES[launch] == 10


def test_keyswitch_span_names_the_gadget(toy_l3, monkeypatch):
    sk, x, y = toy_l3
    monkeypatch.setattr(cmux, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(cmux, "library", _Library)
    monkeypatch.setattr(cmux, "_stream", lambda t: 0)
    acc_t = torch.zeros((2, sk.params.N, 3), dtype=torch.int32)
    with profile():
        cmux.keyswitch(acc_t, sk.cloud.ks_table_perm, sk.params)
    (k,) = [r for r in profiling.spans() if r.name == "tfhe.kernel.keyswitch"]
    assert k.attrs == {"batch": 3, "l": 3}
    assert cmux.FORM_SAMPLES == {}               # not a blind rotate


class _Recording:
    """Stand-in for ``arith.CudaGraph`` on CPU tensors (as in
    tests/test_torch_circuit.py): capture runs the circuit, replay runs it
    again and counts nothing itself."""
    device_type = "cpu"

    def __init__(self, device):
        self.pool_bytes = 0

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        saved = profiling.snapshot()
        new = self.run()
        profiling.counts_since(saved)
        for f in ("a", "b", "cv"):
            getattr(self.out, f).copy_(getattr(new, f))


def test_replays_add_the_form_samples_of_their_capture(monkeypatch):
    graphs = arith.CircuitGraphs(_Recording, max_graphs=3, eager_calls=1)
    monkeypatch.setattr(arith, "GRAPHS", graphs)

    @arith.circuit
    def rotate(x, cloud):
        cmux.count_launch("blind_rotate_ks_fused", x.b.numel(), (3, 2, 1))
        return LweCiphertext(x.a + 1, x.b + 1, x.cv)

    x = LweCiphertext(torch.zeros((5, 4), dtype=torch.int32), torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5))
    cloud = object()
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        counts = []
        for _ in range(4):                       # eager, capture and replay, replay, replay
            rotate(x, cloud)
            counts.append(cmux.FORM_SAMPLES.get(("blind_rotate_ks_fused", 3, 2, 1), 0))
    assert counts == [5, 10, 15, 20]
    entry = next(iter(graphs.entries.values()))
    assert entry.counted["form_samples"] == {("blind_rotate_ks_fused", 3, 2, 1): 5}
