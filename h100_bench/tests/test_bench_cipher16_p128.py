"""The cell cipher16-serial-p128: the serial traffic of cipher16-serial,
unchanged, at the TFHE library's default 128-bit set (configuration
p128-cipher16). Its files and entries, and on the CPU at small sizes (the
toy set with PARAMS_128's gadget, l = 3, and 4-bit numbers; every circuit
eager) a sound run through ``run.execute`` is correct and each planted fault
of ``control`` makes it incorrect."""
import pytest

import control
import harness as H
import run
import tfhe_tpu_torch as tt
from test_bench_run import _check_result

BENCH = H.benchmark()
NAME = "cipher16-serial-p128"
# the cell's traffic at sizes a CPU test holds
SMALL = {"nbits": 4, "pool": 3, "ranges": dict.fromkeys(
    ["add", "sub", "mul", "gt", "eq", "abs", "div"], [-7, 7]) | {"min": [0, 7]}}


def small():
    cell = H.cell(BENCH, NAME)
    return cell, H.config(cell["config"]), H.traffic(cell["traffic"]) | SMALL


def test_the_cell_is_the_serial_traffic_at_the_128_bit_set():
    cell, serial = H.cell(BENCH, NAME), H.cell(BENCH, "cipher16-serial")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "p128-cipher16", serial["traffic"], 1)
    cfg = H.config("p128-cipher16")
    assert run.params_of(cfg) == tt.PARAMS_128
    assert cfg["params"] == H.config("p128-gates")["params"]
    assert cfg["reduced"] == [] and cfg["reference"] == "h100_bench/reference.py"
    (entry,) = [c for c in BENCH["configs"] if c["name"] == "p128-cipher16"]
    assert (entry["file"], entry["source"]) == ("h100_bench/configs/p128-cipher16.json",
                                                cfg["source"])
    assert [m["name"] for m in H.metrics_of(BENCH, NAME, "end_to_end")] == \
        [m["name"] for m in H.metrics_of(BENCH, "cipher16-serial", "end_to_end")]
    # every serial metric but the two whose tests pin their list to cipher16-serial
    pinned = {"serial.pair_ks_pct", "serial.sklansky_pct"}
    assert [m["name"] for m in H.metrics_of(BENCH, NAME, "per_layer")] == \
        [m["name"] for m in H.metrics_of(BENCH, "cipher16-serial", "per_layer")
         if m["name"] not in pinned]


@pytest.fixture
def eager(monkeypatch):
    from tfhe_tpu_torch import arith
    monkeypatch.setattr(arith, "CAPTURE_AFTER", 0)      # the CPU runs circuits eagerly


def test_a_sound_run_at_three_levels_is_correct(eager):
    cell, cfg, traffic = small()
    out = run.execute(cell, cfg, traffic, 2 ** 31 + 1903, 1.0, False, "cpu",
                      params=tt.PARAMS_TOY_L3)
    line = _check_result(cell, cfg, traffic, out)
    assert {"setup_s", "cipher_op_ms_mean", "cipher_op_ms_p95"} == set(line["metrics"])
    assert line["checks"]["wrong_answers"]["value"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_makes_the_run_incorrect(eager, fault):
    cell, cfg, traffic = small()
    out = control.run_with(fault, cell, cfg, traffic, 19, 1.0, "cpu", params=tt.PARAMS_TOY_L3)
    assert not all(c["value"] <= c["limit"] for c in out["checks"]), out["checks"]
