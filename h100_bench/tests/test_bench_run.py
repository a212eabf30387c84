"""The measurement path refuses to run without a card, and the rest of a run
(set-up, warm-up, window, checks, result line) holds on the CPU at small
sizes: every check passes on sound runs."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness as H
import run
import tfhe_tpu_torch as tt
from conftest import HERE, ROOT

BENCH = H.benchmark()
# the cells' traffic at sizes a CPU test holds
SMALL = {
    "gates-b256": {"batch": 24, "check_rows": 6, "check_steps": 3},
    "gates-dp4-b16384": {"batch": 16, "check_rows": 4, "check_steps": 2},
    "cipher16-serial": {"nbits": 4, "pool": 3, "ranges": dict.fromkeys(
        ["add", "sub", "mul", "gt", "eq", "abs", "div"], [-7, 7]) | {"min": [0, 7]}},
    "cipher16-matmul8": {"rows": 2, "inner": 2, "cols": 2, "nbits": 4, "pool": 2,
                         "range": [-8, 7]},
}


def small(name: str):
    cell = H.cell(BENCH, name)
    return cell, H.config(cell["config"]), H.traffic(cell["traffic"]) | SMALL[name]


def _main(args, cwd, env=None):
    return subprocess.run([sys.executable, "h100_bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_refuses_to_run_without_a_card():
    proc = _main(["--workload", "gates-b256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                 ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _main(["--workload", "gates-b256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                 str(tmp_path), env={"PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout == ""


def _check_result(cell, cfg, traffic, out, trace=False):
    line = json.loads(run.report(BENCH, cell, cfg, traffic, out, trace, "cpu"))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] == len(out["jobs"]) > 0
    assert list(line)[-1] == "checks"
    want = {m["name"] for m in H.metrics_of(BENCH, cell["name"],
                                            "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) <= want
    return line


@pytest.mark.parametrize("name", ["gates-b256", "cipher16-serial", "cipher16-matmul8"])
def test_a_sound_run_is_correct(name, monkeypatch):
    from tfhe_tpu_torch import arith
    monkeypatch.setattr(arith, "CAPTURE_AFTER", 0)      # the CPU runs circuits eagerly
    cell, cfg, traffic = small(name)
    out = run.execute(cell, cfg, traffic, 2 ** 31 + 99, 1.0, False, "cpu",
                      params=tt.PARAMS_TOY)
    line = _check_result(cell, cfg, traffic, out)
    assert {"setup_s"} < set(line["metrics"])


def test_a_sound_run_over_two_ranks_is_correct():
    cell, cfg, traffic = small("gates-dp4-b16384")
    out = run.execute_ranks(cell, cfg, traffic, 31, 1.0, False, 2, device="cpu",
                            params=tt.PARAMS_TOY)
    line = _check_result(cell, cfg, traffic, out)
    assert line["checks"]["rank_mismatch_steps"]["value"] == 0
    assert line["device"]["count"] == 2
