"""The readers of the program's spans and graph counters: the right value on
a store made by hand, nothing on an empty store or where the program has no
spans (a checkout before them), and a traced run of the gate cell on the CPU
that reports the host's time a gate call."""
import collections
import json
from types import SimpleNamespace

import pytest

import harness as H
import run
import tfhe_tpu_torch as tt
from tfhe_tpu_torch import arith
from tfhe_tpu_torch.utils import profiling

BENCH = H.benchmark()
MS = 1_000_000          # ns


def _run(cell: str, n_jobs: int):
    c = H.cell(BENCH, cell)
    jobs = [H.Job(0.1 * i, 0.1 * (i + 1), 1) for i in range(n_jobs)]
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 window_s=0.1 * n_jobs, jobs=jobs)


def _span(name, id, parent=None, ms=1.0, **attrs):
    return profiling.SpanRecord(name, id, parent, id if parent is None else parent, 0,
                                int(ms * MS), attrs)


STORE = [
    _span("tfhe.gate2", 1, ms=3.0, kind="AND", batch=256),
    _span("tfhe.bootstrap", 2, parent=1, ms=2.0),
    _span("tfhe.gate2", 3, ms=5.0, kind="OR", batch=256),
    _span("tfhe.mesh.sharded_gate2", 4, ms=7.0),
    _span("tfhe.gate2", 5, parent=4, ms=100.0),          # not outermost: not counted
    _span("tfhe.circuit", 6, ms=30.0, mode="replay"),
    _span("tfhe.circuit.launch", 7, parent=6, ms=2.5),
    _span("tfhe.circuit", 8, ms=700.0, mode="replay"),
    _span("tfhe.circuit.launch", 9, parent=8, ms=25.0),
    _span("tfhe.circuit", 10, ms=30.0, mode="replay"),
    _span("tfhe.circuit.launch", 11, parent=10, ms=1.5),
    _span("tfhe.circuit", 12, ms=40.0, mode="eager"),
]


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def test_readers_on_a_store_made_by_hand(store):
    store.extend(STORE)
    assert H.reader("gates.host_ms_per_call")(_run("gates-b256", 3)) == pytest.approx(5.0)
    assert H.reader("serial.replay_pct")(_run("cipher16-serial", 4)) == pytest.approx(75.0)
    assert H.reader("serial.launch_ms_per_op")(_run("cipher16-serial", 4)) == \
        pytest.approx((2.5 + 25.0 + 1.5) / 4)


def test_readers_find_nothing_in_an_empty_store(store):
    for name in ("gates.host_ms_per_call", "serial.replay_pct", "serial.launch_ms_per_op"):
        assert H.reader(name)(_run("cipher16-serial", 4)) is None, name
    store.append(_span("tfhe.circuit", 1, mode="replay"))
    assert H.reader("serial.launch_ms_per_op")(_run("cipher16-serial", 0)) is None


def test_graph_warm_seconds(monkeypatch):
    graphs = SimpleNamespace(seconds=collections.Counter(first=1.5, eager=12.0, capture=2.25))
    monkeypatch.setattr(arith, "GRAPHS", graphs)
    assert H.reader("serial.graph_warm_s")(_run("cipher16-serial", 4)) == pytest.approx(14.25)
    del graphs.seconds["eager"], graphs.seconds["capture"]
    assert H.reader("serial.graph_warm_s")(_run("cipher16-serial", 4)) is None
    graphs.seconds.clear()
    assert H.reader("serial.graph_warm_s")(_run("cipher16-serial", 4)) is None


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    """A checkout whose program has no span store or graph seconds: every
    reader returns None and none raises."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.setattr(arith, "GRAPHS", SimpleNamespace(counts=collections.Counter()))
    for name in ("gates.host_ms_per_call", "serial.replay_pct", "serial.launch_ms_per_op",
                 "serial.graph_warm_s"):
        assert H.reader(name)(_run("cipher16-serial", 4)) is None, name


def test_a_traced_gate_run_reports_the_host_time_of_a_call():
    profiling.reset_spans()
    cell = H.cell(BENCH, "gates-b256")
    cfg = H.config(cell["config"])
    traffic = H.traffic(cell["traffic"]) | {"batch": 24, "check_rows": 6, "check_steps": 3}
    out = run.execute(cell, cfg, traffic, 2 ** 31 + 7, 1.0, True, "cpu", params=tt.PARAMS_TOY)
    line = json.loads(run.report(BENCH, cell, cfg, traffic, out, True, "cpu"))
    profiling.reset_spans()
    assert line["correct"], line["checks"]
    assert line["metrics"]["gates.host_ms_per_call"]["value"] > 0
    assert line["metrics"]["gates.host_ms_per_call"]["unit"] == "ms"
