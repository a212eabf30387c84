"""tfhe_tpu_torch.utils.profiling's spans, held on the CPU at PARAMS_TOY.

Without a profiler a span is the shared NO_SPAN: a gate records nothing and
never enters ``record_function``. Under ``torch.profiler.profile`` one gate
records ``tfhe.gate2`` -> ``tfhe.bootstrap`` -> ``prepare_acc`` / ``finish``
with their parents, one root id, self times and attributes, and the same
names lie in the profiler's trace inside the caller's ``record_function``.
The host part of a kernel wrapper is its span (the CUDA branch, reached here
with the library stood in for), ``arith.circuit``'s outer calls name their
mode, ``CircuitGraphs.seconds`` times every mode but replay, and the store
stops growing at its cap."""
import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, config, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.ops import cmux, cmux_packed
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def toy():
    sk = pt.keygen(pt.PARAMS_TOY, seed=11, device="cpu")
    g = torch.Generator().manual_seed(5)
    x = pt.encrypt_bits(sk, np.array([0, 1, 1, 0], np.int32), g, "cpu")
    y = pt.encrypt_bits(sk, np.array([0, 0, 1, 1], np.int32), g, "cpu")
    return sk, x, y


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_no_profiler_records_nothing(toy, monkeypatch):
    sk, x, y = toy

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("tfhe.gate2", kind="AND") is profiling.NO_SPAN
    with profiling.span("tfhe.gate2") as sp:
        assert not sp
        sp.set(mode="replay")
    out = gates.gate2("AND", x, y, sk.cloud)
    assert pt.decrypt_bits(sk, out).tolist() == [0, 0, 1, 0]
    assert profiling.spans() == [] and profiling.span_counts() == {}


# (TFHE_TPU_FUSEKS, small batch) -> the route the bootstrap span names
ROUTES = {("1", True): "k5", ("1", False): "k4", ("0", True): "k5_woks", ("0", False): "k3"}


@pytest.mark.parametrize("fuseks,small", list(ROUTES))
def test_gate2_spans_under_the_profiler(toy, monkeypatch, fuseks, small):
    sk, x, y = toy
    monkeypatch.setattr(bs, "small_batch", lambda B, params=None: small)
    with config.overrides(TFHE_TPU_FUSEKS=fuseks):
        with profile() as prof:
            with record_function("caller"):
                out = gates.gate2("XOR", x, y, sk.cloud)
    assert pt.decrypt_bits(sk, out).tolist() == [0, 1, 0, 1]
    recs = profiling.spans()
    assert [r.name for r in recs] == ["tfhe.gate2", "tfhe.bootstrap",
                                      "tfhe.bootstrap.prepare_acc", "tfhe.bootstrap.finish"]
    gate, boot, prep, fin = recs
    assert gate.parent is None and boot.parent == gate.id
    assert prep.parent == boot.id and fin.parent == boot.id
    assert {r.root for r in recs} == {gate.id}
    assert len({r.id for r in recs}) == 4
    assert gate.attrs == {"kind": "XOR", "batch": 4}
    assert boot.attrs == {"route": ROUTES[fuseks, small], "form": "plain", "l": 2, "batch": 4,
                          "parts": 1}
    for r in recs:
        kids = [c for c in recs if c.parent == r.id]
        assert r.self_ns == r.duration_ns - sum(c.duration_ns for c in kids) >= 0
        assert all(r.start_ns <= c.start_ns and c.end_ns <= r.end_ns for c in kids)
    assert profiling.span_counts() == {r.name: 1 for r in recs}
    events = _by_name(prof.events())
    (caller,) = events["caller"]
    for r in recs:
        (ev,) = events[r.name]
        assert caller.time_range.start <= ev.time_range.start
        assert ev.time_range.end <= caller.time_range.end


class _Library:
    """Stands in for the CUDA library: every entry point returns success."""
    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("small,wrapper,kernel,form", [
    (False, "blind_rotate_ks_fused", "blind_rotate_ks_fused", "2/2"),
    (True, "blind_rotate_packed_ks_fused", "blind_rotate_fused_packed", "c2")])
def test_kernel_wrapper_span_beside_its_launch(toy, monkeypatch, small, wrapper, kernel, form):
    """The CUDA branch of a wrapper, reached with CPU tensors and nothing
    launched: its checks, plans and library call are the span
    tfhe.kernel.<wrapper>, inside the bootstrap, one per counted launch."""
    sk, x, y = toy
    for mod in (cmux, cmux_packed):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "library", _Library)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(cmux_packed, "small_cluster", lambda B, N, device, l: 2)
    monkeypatch.setattr(bs, "small_batch", lambda B, params=None: small)
    cmux.reset_launches()
    with config.overrides(TFHE_TPU_FUSEKS="1"), profile():
        gates.gate2("AND", x, y, sk.cloud)
    recs = _by_name(profiling.spans())
    (k,) = recs[f"tfhe.kernel.{wrapper}"]
    (boot,) = recs["tfhe.bootstrap"]
    assert k.parent == boot.id and k.attrs == {"batch": 4, "l": 2, "form": form}
    assert cmux.LAUNCHES[kernel] == cmux.LAUNCHES["keyswitch"] == 1
    assert cmux.SAMPLES[kernel] == 4
    cmux.reset_launches()


class _StandIn:
    """Stands in for arith.CudaGraph on CPU tensors: capture runs the
    circuit, replay runs it again on the graph's inputs into its outputs."""
    device_type = "cpu"

    def __init__(self, device):
        self.pool_bytes = 0

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        new = self.run()
        for f in ("a", "b", "cv"):
            getattr(self.out, f).copy_(getattr(new, f))


def _ct(seed: int) -> LweCiphertext:
    g = torch.Generator().manual_seed(seed)
    return LweCiphertext(torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 4, 8), generator=g,
                                       dtype=torch.int32),
                         torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 4), generator=g,
                                       dtype=torch.int32),
                         torch.rand((2, 4), generator=g))


def test_circuit_modes_and_seconds(monkeypatch):
    """first, eager, capture, replay under the graphs (the capture with a
    capture and a launch child, each replay a launch child); off (a keyword
    argument) and over_rule (past CAPTURE_MAX_BATCH) around them; seconds for
    every mode the graphs time and none for replay."""
    g = arith.CircuitGraphs(_StandIn, eager_calls=2)
    monkeypatch.setattr(arith, "GRAPHS", g)

    @arith.circuit
    def bump(x, cloud, step=1):
        return LweCiphertext(x.a + step, x.b + step, x.cv)

    cloud, x = object(), _ct(1)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"), profile():
        for _ in range(5):
            out = bump(x, cloud)
        bump(x, cloud, step=1)
        monkeypatch.setattr(arith, "CAPTURE_MAX_BATCH", 1)
        bump(x, cloud)
    assert torch.equal(out.a, x.a + 1) and torch.equal(out.b, x.b + 1)
    recs = profiling.spans()
    calls = [r for r in recs if r.name == "tfhe.circuit"]
    assert [r.attrs["mode"] for r in calls] == [
        "first", "eager", "capture", "replay", "replay", "off", "over_rule"]
    assert all(r.parent is None and r.attrs["circuit"] == bump.__qualname__ for r in calls)
    for r in calls:
        kids = [c.name for c in recs if c.parent == r.id]
        want = {"capture": ["tfhe.circuit.capture", "tfhe.circuit.launch"],
                "replay": ["tfhe.circuit.launch"]}.get(r.attrs["mode"], [])
        assert kids == want, r
    assert set(g.seconds) == {"first", "eager", "capture"}
    assert all(v > 0 for v in g.seconds.values())
    assert g.counts == {"first": 1, "eager": 1, "capture": 1, "replay": 2, "over_rule": 1}


def test_circuit_span_names_the_adders_arm(monkeypatch):
    """tfhe.circuit carries the arm its adders took in every mode, a
    replay's from its capture; "mixed" where they took both; nothing where
    the circuit decides none."""
    g = arith.CircuitGraphs(_StandIn, eager_calls=2)
    monkeypatch.setattr(arith, "GRAPHS", g)
    cloud = SimpleNamespace(params=pt.PARAMS_TOY)

    @arith.circuit
    def adds(x, cloud, numbers=(1,), forced=()):
        for m in numbers:
            arith._latency_policy(m, 16, x.device, cloud)
        for arm in forced:
            with config.overrides(TFHE_TPU_LOOKAHEAD=arm):
                arith._latency_policy(1, 16, x.device, cloud)
        return LweCiphertext(x.a + 1, x.b, x.cv)

    x = _ct(3)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"), profile():
        for _ in range(5):
            adds(x, cloud)
        with config.overrides(TFHE_TPU_LOOKAHEAD="1"):
            adds(x, cloud)
        adds(x, cloud, numbers=())
    calls = [r.attrs for r in profiling.spans() if r.name == "tfhe.circuit"]
    assert [(a["mode"], a.get("arm")) for a in calls] == [
        ("first", "ripple"), ("eager", "ripple"), ("capture", "ripple"), ("replay", "ripple"),
        ("replay", "ripple"), ("first", "prefix"), ("off", None)]

    profiling.reset_spans()
    with profile():
        adds(x, cloud, numbers=(), forced=("1", "0"))
    (call,) = [r.attrs for r in profiling.spans() if r.name == "tfhe.circuit"]
    assert call == {"circuit": adds.__qualname__, "mode": "off", "arm": "mixed"}


def test_circuit_seconds_without_a_profiler(monkeypatch):
    """The graphs' seconds are kept whether or not a profiler records."""
    g = arith.CircuitGraphs(_StandIn, eager_calls=1)
    monkeypatch.setattr(arith, "GRAPHS", g)

    @arith.circuit
    def bump(x, cloud):
        return LweCiphertext(x.a + 1, x.b, x.cv)

    cloud, x = object(), _ct(2)
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        for _ in range(3):
            bump(x, cloud)
    assert set(g.seconds) == {"first", "capture"} and profiling.spans() == []


def test_store_stops_growing_at_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 5)
    with profile():
        for i in range(8):
            with profiling.span("tfhe.test", i=i):
                with profiling.span("tfhe.test.inner"):
                    pass
    recs = profiling.spans()
    # the first five to close, in the order they opened
    assert len(recs) == 5
    assert [(r.name, r.attrs.get("i")) for r in recs] == [
        ("tfhe.test", 0), ("tfhe.test.inner", None), ("tfhe.test", 1),
        ("tfhe.test.inner", None), ("tfhe.test.inner", None)]
    assert profiling.span_counts() == {"tfhe.test": 8, "tfhe.test.inner": 8}
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.span_counts() == {}


def test_kept_spans_leave_the_garbage_collector():
    """A kept span of numbers and strings is a flat tuple that the garbage
    collector stops tracking at its first pass, so a long traced window adds
    nothing to a full collection."""
    with profile():
        for i in range(50):
            with profiling.span("tfhe.gate2", kind="AND", batch=256) as sp:
                sp.set(mode="replay")
    gc.collect()
    assert len(profiling._STORE) == 50
    assert not any(gc.is_tracked(t) for t in profiling._STORE)
    (first, *_) = profiling.spans()
    assert first.attrs == {"kind": "AND", "batch": 256, "mode": "replay"}


def test_chip_smoke_counts_no_span_as_device_work():
    """The smoke script's device time and idle share count kernels only: a
    span's mirror on the device's timeline (a user annotation from its first
    kernel to its last) is left out, as the benchmark's devtrace leaves it."""
    import chip_smoke

    def ev(name, start, end, annotation=False, device=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [ev("tfhe.gate2", 0, 100, annotation=True), ev("tfhe.gate2", 0, 120,
                                                            device=torch.autograd.DeviceType.CPU),
              ev("blind_rotate_kernel", 0, 40), ev("ks_mma_kernel", 60, 100)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in chip_smoke.device_events(prof)] == ["blind_rotate_kernel",
                                                                "ks_mma_kernel"]
