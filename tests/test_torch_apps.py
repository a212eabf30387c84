"""The port's alice / cloud / verify / cli apps against tfhe_tpu's.

The client/cloud/client trip of tests/test_apps.py over secret.key /
cloud.key / cloud.data / answer.data with ``--device cpu``; mixed trips, where
tfhe_tpu's alice and verify stand around the port's cloud and the port's
answer.data equals the JAX cloud's byte for byte; the experiment suite at toy
size; and the rule that an app without ``--device`` and without a card raises
and computes nothing; and utils.profiling, which cli and cloud time with, on
the CPU."""
import json
import os

import pytest
import torch

from tfhe_tpu.apps import alice as j_alice, cloud as j_cloud, verify as j_verify
from tfhe_tpu_torch.apps import alice, cli, cloud, verify
from tfhe_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def test_alice_cloud_verify_roundtrip(tmp_path):
    """The whole trip through the four files, toy params, 4-bit add."""
    d = str(tmp_path)
    alice.main(["5", "3", "--bits", "4", "--dir", d, "--params", "toy"] + CPU)
    assert os.path.exists(os.path.join(d, "secret.key"))
    assert os.path.exists(os.path.join(d, "cloud.key"))
    cloud.main(["--op", "add", "--bits", "4", "--dir", d] + CPU)
    assert verify.main(["--bits", "4", "--dir", d] + CPU) == 5 + 3 - 16   # 8 wraps to -8
    assert verify.main(["--bits", "4", "--dir", d, "--unsigned"] + CPU) == 8


@pytest.mark.parametrize("op,want", [("add", 7), ("sub", 3), ("mul", -6), ("min", 2)])
def test_mixed_trip(tmp_path, op, want):
    """tfhe_tpu's alice, then both clouds on the same cloud.key / cloud.data:
    the port's answer.data is the JAX cloud's byte for byte, and tfhe_tpu's
    verify and the port's decrypt it alike."""
    d = str(tmp_path)
    j_alice.main(["5", "2", "--bits", "4", "--dir", d, "--params", "toy"])
    j_cloud.main(["--op", op, "--bits", "4", "--dir", d])
    theirs = _read(d, "answer.data")
    os.remove(os.path.join(d, "answer.data"))
    cloud.main(["--op", op, "--bits", "4", "--dir", d] + CPU)
    assert _read(d, "answer.data") == theirs
    assert j_verify.main(["--bits", "4", "--dir", d]) == want
    assert verify.main(["--bits", "4", "--dir", d] + CPU) == want


def test_port_alice_jax_cloud(tmp_path):
    """The other way round: the port's files serve tfhe_tpu's cloud and verify."""
    d = str(tmp_path)
    alice.main(["6", "-3", "--bits", "4", "--dir", d, "--params", "toy"] + CPU)
    j_cloud.main(["--op", "add", "--bits", "4", "--dir", d])
    assert j_verify.main(["--bits", "4", "--dir", d]) == 3
    assert verify.main(["--bits", "4", "--dir", d] + CPU) == 3


def test_cli_toy(capsys):
    """Every experiment of apps.cli at toy size decrypts right."""
    assert cli.main(["4", "5", "3", "4", "--params", "toy"] + CPU) == 0
    out = capsys.readouterr().out
    assert "ALL OK" in out and "FAIL" not in out
    for line in ("AND", "XOR", "add(GPU_1)", "add(GPU_n)", "mul(naive)", "mul(karatsuba)",
                 "vector add", "vector mul", "matmul", "cannon"):
        assert line in out
    report = out.split("== time by phase ==")[1]
    for phase in ("keygen", "AND||XOR", "mul(karatsuba)", "cannon"):
        assert f"{phase:24s} total" in report


def test_cli_reports_a_wrong_result(monkeypatch, capsys):
    """A circuit that decrypts wrong makes apps.cli return 1."""
    from tfhe_tpu_torch import arith
    monkeypatch.setattr(arith, "add", arith.sub)
    assert cli.main(["4", "5", "3", "--params", "toy", "--experiments", "add"] + CPU) == 1
    assert "FAILURES PRESENT" in capsys.readouterr().out


@pytest.mark.parametrize("app,argv", [
    (alice, ["5", "3", "--bits", "4", "--params", "toy"]),
    (cloud, ["--op", "add", "--bits", "4"]),
    (verify, ["--bits", "4"]),
    (cli, ["4", "5", "3", "4", "--params", "toy"]),
])
def test_app_without_device_needs_the_card(tmp_path, monkeypatch, app, argv):
    """No --device and no card: the app raises and writes nothing; it does
    not move to the CPU on its own, toy parameters or not."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    d = str(tmp_path)
    alice.main(["5", "3", "--bits", "4", "--dir", d, "--params", "toy"] + CPU)
    cloud.main(["--op", "add", "--bits", "4", "--dir", d] + CPU)
    before = {name: _read(d, name) for name in os.listdir(d)}
    monkeypatch.chdir(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(argv)
    assert {name: _read(d, name) for name in os.listdir(d)} == before


def test_profiling_on_the_cpu(tmp_path):
    """PhaseTimer sums and counts a phase entered twice and reports it;
    device_trace writes a Chrome trace that holds the body's ops."""
    calls = []

    def fn(x):
        calls.append(x)
        return x @ x

    x = torch.eye(3)
    timer = profiling.PhaseTimer("cpu")
    for _ in range(2):
        with timer.phase("product"):
            fn(x)
    with pytest.raises(ZeroDivisionError), timer.phase("fails"):
        1 / 0
    assert len(calls) == 2
    assert timer.counts == {"product": 2, "fails": 1} and timer.totals["product"] > 0
    assert [line.split()[0] for line in timer.report().splitlines()] == sorted(
        timer.totals, key=lambda name: -timer.totals[name])
    assert "n=2" in timer.report()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        fn(x)
    assert any("mm" in ev.name for ev in prof.events())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
