"""Each fault a cell can have, planted under a whole run, makes `correct`
false: a blind rotate that returns its state unchanged, half of each batch
left out, an answer altered where it is produced, and (across ranks) the
exchange left out. The control, the reference in float32 in the program's
place, fails the word-for-word check of the gate cells here, and on the card
at each cell's own size (run with -m cuda on the chip)."""
import pytest

import control
import harness as H
import run
import tfhe_tpu_torch as tt
from test_bench_run import small

ONE_CARD = ["gates-b256", "cipher16-serial", "cipher16-matmul8"]


def _correct(out) -> bool:
    return all(c["value"] <= c["limit"] for c in out["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    from tfhe_tpu_torch import arith
    monkeypatch.setattr(arith, "CAPTURE_AFTER", 0)
    cell, cfg, traffic = small(name)
    out = control.run_with(fault, cell, cfg, traffic, 5, 1.0, "cpu", params=tt.PARAMS_TOY)
    assert not _correct(out), out["checks"]


def test_the_exchange_left_out_makes_the_run_incorrect():
    cell, cfg, traffic = small("gates-dp4-b16384")
    out = control.run_with("no_exchange", cell, cfg, traffic, 6, 1.0, "cpu",
                           params=tt.PARAMS_TOY)
    assert not _correct(out), out["checks"]
    checks = {c["name"]: c["value"] for c in out["checks"]}
    assert checks["rank_mismatch_steps"] > 0 or checks["wrong_bits"] > 0


def test_the_control_fails_the_gate_cell():
    cell, cfg, traffic = small("gates-b256")
    out = control.run_with("control", cell, cfg, traffic, 8, 1.0, "cpu",
                           params=tt.PARAMS_SMALL_NOISY)
    checks = {c["name"]: c["value"] for c in out["checks"]}
    assert checks["mismatch_words"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_at_the_cells_size_is_incorrect(name, card):
    cell = H.cell(H.benchmark(), name)
    cfg, traffic = H.config(cell["config"]), H.traffic(cell["traffic"])
    for seed in (101, 202, 2 ** 31 + 303):
        out = control.run_with("control", cell, cfg, traffic, seed, 20.0, "cuda")
        assert not _correct(out), out["checks"]
