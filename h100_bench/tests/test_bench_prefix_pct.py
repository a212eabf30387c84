"""The readers of the adders' arm counter: ``serial.prefix_pct`` and
``matmul.prefix_pct`` read ``arith.ADDER_ARMS`` at the end of the run, and
report nothing where there was no decision or no counter (a program before
it)."""
import harness as H
from tfhe_tpu_torch import arith

BENCH = H.benchmark()


def _run(cell: str, n_jobs: int):
    c = H.cell(BENCH, cell)
    jobs = [H.Job(0.1 * i, 0.1 * (i + 1), 1) for i in range(n_jobs)]
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 window_s=0.1 * n_jobs, jobs=jobs)


def test_prefix_share_of_the_adders_decisions(monkeypatch):
    """100 where every decision took the prefix arm, 0 where none did, nothing
    where there was no decision or no counter."""
    for arms, want in (({"prefix": 24, "ripple": 0}, 100.0), ({"prefix": 0, "ripple": 7}, 0.0),
                       ({"prefix": 1, "ripple": 3}, 25.0), ({"prefix": 0, "ripple": 0}, None)):
        monkeypatch.setattr(arith, "ADDER_ARMS", arms)
        assert H.reader("serial.prefix_pct")(_run("cipher16-serial", 4)) == want
        assert H.reader("matmul.prefix_pct")(_run("cipher16-matmul8", 1)) == want
    monkeypatch.delattr(arith, "ADDER_ARMS")
    assert H.reader("serial.prefix_pct")(_run("cipher16-serial", 4)) is None
    assert H.reader("matmul.prefix_pct")(_run("cipher16-matmul8", 1)) is None
