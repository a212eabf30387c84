"""The reader of K5's forms, ``serial.c4_stage_pct``: K5's launches in
clusters of four over those in clusters of four or two, from
``ops.cmux_packed.CLUSTERS`` at the end of the run; nothing where no K5
stage ran on the card or the program has no such counter (a program before
it)."""
import pytest

import harness as H
from tfhe_tpu_torch.ops import cmux_packed

BENCH = H.benchmark()


def _run(name: str):
    c = H.cell(BENCH, name)
    jobs = [H.Job(0.1 * i, 0.1 * (i + 1), 1) for i in range(4)]
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 window_s=0.4, jobs=jobs)


@pytest.mark.parametrize("name", ["cipher16-serial", "cipher16-serial-p128"])
def test_share_of_the_k5_stages_in_clusters_of_four(monkeypatch, name):
    read = H.reader("serial.c4_stage_pct")
    for clusters, want in (
            ({"c4": 3, "c2": 1}, 75.0),
            ({"c4": 8, "c2": 0}, 100.0),
            ({"c4": 0, "c2": 4}, 0.0),
            ({"c4": 1, "c2": 4}, 20.0),
            ({"c4": 0, "c2": 0}, None),                 # no K5 stage on the card
            ({}, None)):
        monkeypatch.setattr(cmux_packed, "CLUSTERS", clusters)
        assert read(_run(name)) == want
    monkeypatch.delattr(cmux_packed, "CLUSTERS")
    assert read(_run(name)) is None


def test_listed_for_both_serial_cells():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "serial.c4_stage_pct"]
    assert (m["layer"], m["moves"], m["workloads"], m["source"], m["unit"]) == (
        "kernels", "cipher_op_ms_mean", ["cipher16-serial", "cipher16-serial-p128"],
        "program_counter", "%")
