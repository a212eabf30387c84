"""The reader of ``k4.samples_per_key_read``: the mean S of K4's samples from
``ops.cmux.FORM_SAMPLES`` on counters made by hand, nothing where the program
has no such counter (a checkout before it) or launched no K4, the cells that
list it, and on the card a traced run of the gate cell at each gadget length
at a batch that takes K4."""
import json

import pytest

import harness as H
import run
import tfhe_tpu_torch as tt
from tfhe_tpu_torch.ops import cmux
from tfhe_tpu_torch.utils import profiling

BENCH = H.benchmark()
READ = H.reader("k4.samples_per_key_read")


def _run(cell: str):
    c = H.cell(BENCH, cell)
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]))


@pytest.fixture
def forms(monkeypatch):
    held = {}
    monkeypatch.setattr(cmux, "FORM_SAMPLES", held)
    return held


def test_mean_samples_a_key_read_of_k4(forms):
    forms[("blind_rotate_ks_fused", 2, 2, 2)] = 512
    assert READ(_run("gates-b256")) == 2.0
    forms.clear()
    forms[("blind_rotate_ks_fused", 3, 2, 1)] = 300
    forms[("blind_rotate_ks_fused", 3, 1, 0)] = 100
    forms[("blind_rotate_fused", 3, 1, 0)] = 10_000            # K3: not read
    forms[("blind_rotate_fused_packed", 3, 1, 2)] = 10_000     # K5: not read
    assert READ(_run("gates128-b256")) == pytest.approx((2 * 300 + 1 * 100) / 400)


def test_nothing_without_k4(forms):
    assert READ(_run("gates-b256")) is None
    forms[("blind_rotate_fused_packed", 2, 1, 2)] = 30
    assert READ(_run("gates-b256")) is None


def test_nothing_in_a_program_without_the_counter(monkeypatch):
    monkeypatch.delattr(cmux, "FORM_SAMPLES")
    assert READ(_run("gates-b256")) is None


def test_the_cells_that_read_it():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "k4.samples_per_key_read"]
    assert m["workloads"] == ["gates-b256", "gates128-b256"]
    assert m["moves"] == "gates_per_s" and m["layer"] == "kernels"
    assert H.cell(BENCH, "gates128-b256")["config"] == "p128-gates"
    cfg = H.config("p128-gates")
    assert run.params_of(cfg) == tt.PARAMS_128


@pytest.mark.parametrize("P", [tt.PARAMS_TOY, tt.PARAMS_TOY_L3], ids=["l2", "l3"])
def test_a_traced_gate_run_on_the_card_reads_two(card, P):
    """The gate cell's loop at a batch of 264 (K4 at l = 2 in the form (2, 2),
    at l = 3 in (2, 1)) on the card, traced: the reader gives S = 2."""
    profiling.reset_spans()
    cmux.reset_launches()
    cell = H.cell(BENCH, "gates-b256")
    cfg = H.config(cell["config"])
    traffic = H.traffic(cell["traffic"]) | {"batch": 264, "check_rows": 8, "check_steps": 2}
    out = run.execute(cell, cfg, traffic, 2 ** 31 + 11, 1.0, True, "cuda", params=P)
    line = json.loads(run.report(BENCH, cell, cfg, traffic, out, True, "gpu"))
    profiling.reset_spans()
    assert line["correct"], line["checks"]
    assert line["metrics"]["k4.samples_per_key_read"]["value"] == 2.0
