"""The reader of the prefix arm's network counter: ``serial.sklansky_pct``
reads ``arith.PREFIX_NETWORKS`` at the end of the run, and reports nothing
where no prefix chain ran or there is no counter (a program before it)."""
import harness as H
from tfhe_tpu_torch import arith

BENCH = H.benchmark()


def _run(n_jobs: int):
    c = H.cell(BENCH, "cipher16-serial")
    jobs = [H.Job(0.1 * i, 0.1 * (i + 1), 1) for i in range(n_jobs)]
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 window_s=0.1 * n_jobs, jobs=jobs)


def test_sklansky_share_of_the_prefix_chains(monkeypatch):
    """100 where every chain ran Sklansky, 0 where none did, nothing where
    no chain ran or there is no counter."""
    read = H.reader("serial.sklansky_pct")
    for networks, want in (({"kogge_stone": 0, "sklansky": 22}, 100.0),
                           ({"kogge_stone": 5, "sklansky": 0}, 0.0),
                           ({"kogge_stone": 1, "sklansky": 3}, 75.0),
                           ({"kogge_stone": 0, "sklansky": 0}, None)):
        monkeypatch.setattr(arith, "PREFIX_NETWORKS", networks)
        assert read(_run(4)) == want
    monkeypatch.delattr(arith, "PREFIX_NETWORKS")
    assert read(_run(4)) is None


def test_listed_for_the_serial_cell_only():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "serial.sklansky_pct"]
    assert (m["layer"], m["moves"], m["workloads"], m["source"]) == (
        "serial circuit", "cipher_op_ms_mean", ["cipher16-serial"], "program_counter")
