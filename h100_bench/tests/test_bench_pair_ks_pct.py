"""The reader of the paired key switch's route counter: ``serial.pair_ks_pct``
reads ``core.bootstrap.PAIR_KS`` at the end of the run, and reports nothing
where no key switch was paired or there is no counter (a program before
it)."""
import harness as H
from tfhe_tpu_torch.core import bootstrap as bs

BENCH = H.benchmark()


def _run(n_jobs: int):
    c = H.cell(BENCH, "cipher16-serial")
    jobs = [H.Job(0.1 * i, 0.1 * (i + 1), 1) for i in range(n_jobs)]
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 window_s=0.1 * n_jobs, jobs=jobs)


def test_kernel_share_of_the_paired_key_switches(monkeypatch):
    """100 where every paired key switch ran in the kernels, 0 where none
    did, nothing where none ran or there is no counter."""
    read = H.reader("serial.pair_ks_pct")
    for routes, want in (({"kernel": 114, "split": 0}, 100.0), ({"kernel": 0, "split": 9}, 0.0),
                         ({"kernel": 3, "split": 1}, 75.0), ({"kernel": 0, "split": 0}, None)):
        monkeypatch.setattr(bs, "PAIR_KS", routes)
        assert read(_run(4)) == want
    monkeypatch.delattr(bs, "PAIR_KS")
    assert read(_run(4)) is None


def test_listed_for_the_serial_cell_only():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "serial.pair_ks_pct"]
    assert (m["layer"], m["moves"], m["workloads"]) == ("kernels", "cipher_op_ms_mean",
                                                       ["cipher16-serial"])
