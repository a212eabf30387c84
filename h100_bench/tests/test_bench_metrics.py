"""The metric arithmetic: a rate over the whole window, a p95 over all
requests, the roofline's counts at PARAMS_110's shapes, and readers that find
nothing to read return nothing."""
import math

import numpy as np
import pytest

import harness as H
import roofline
from tfhe_tpu_torch import PARAMS_110

BENCH = H.benchmark()


def _run(cell: str, jobs, window_s, trace=None, counters=None, ranks=()):
    c = H.cell(BENCH, cell)
    return H.Run(cell=c, traffic=H.traffic(c["traffic"]), config=H.config(c["config"]),
                 setup_s=12.5, window_s=window_s, jobs=jobs, counters=counters or {},
                 trace=trace, ranks=list(ranks))


def test_gate_rate_is_all_the_work_over_all_the_window():
    jobs = [H.Job(0.01 * i, 0.01 * i + 0.007, 256) for i in range(100)]
    run = _run("gates-b256", jobs, window_s=jobs[-1].end)
    assert H.reader("gates_per_s")(run) == pytest.approx(25600 / 0.997)
    assert H.reader("setup_s")(run) == 12.5
    assert H.reader("matmul_s")(run) is None


def test_cipher_mean_and_p95_over_every_request():
    lat = [0.03] * 90 + [0.7] * 10 + [0.2] * 20
    jobs, t = [], 0.0
    for x in lat:
        jobs.append(H.Job(t, t + x, 1))
        t += x + 0.001
    run = _run("cipher16-serial", jobs, window_s=jobs[-1].end)
    assert H.reader("cipher_op_ms_mean")(run) == pytest.approx(1e3 * jobs[-1].end / 120)
    assert H.reader("cipher_op_ms_p95")(run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert H.reader("gates_per_s")(run) is None


def test_matmul_seconds_a_product():
    jobs = [H.Job(4.7 * i, 4.7 * (i + 1), 1) for i in range(7)]
    assert H.reader("matmul_s")(_run("cipher16-matmul8", jobs, 32.9)) == pytest.approx(4.7)


def test_roofline_counts_at_params_110():
    # per prime (4 + 2) transforms of 512 * 10 butterflies, 1024 * 4 * 2 products
    assert roofline.cmux_step_ops(PARAMS_110) == 2 * 6 * 512 * 10 * 7 + 2 * 1024 * 8 * 5
    assert roofline.key_bytes(PARAMS_110) == 2 * 500 * 2 * 8 * 1024 * 4      # 65.5 MB
    assert roofline.ks_table_bytes(PARAMS_110) == 24 * 1024 * 4 * 512
    assert roofline.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    # K4 at one batch of 256: bound by its operations, 3.917 ms
    k4 = roofline.blind_rotate_bound_s(PARAMS_110, 1, 256, fused_ks=True)
    assert k4 == pytest.approx(256 * 500 * 512000 / (132 * 64 * 1.98e9))
    assert 3.9e-3 < k4 < 3.95e-3
    # K5 at one sample: bound by the key's bytes, 19.6 us
    k5 = roofline.blind_rotate_bound_s(PARAMS_110, 1, 1, fused_ks=False)
    assert k5 == pytest.approx((65536000 + 2 * 8192 + 2000) / 3.35e12)


def _summary(kernels, window_s):
    by = {}
    for n, t in kernels:
        by[n] = by.get(n, 0.0) + t
    return {"window_s": window_s, "busy_s": sum(t for _, t in kernels), "kernels": kernels,
            "by_name": by, "idle_gaps": []}


def test_trace_readers():
    launches = dict.fromkeys(("cmux_delta", "blind_rotate_step", "blind_rotate_fused",
                              "blind_rotate_ks_fused", "blind_rotate_fused_packed",
                              "keyswitch"), 0)
    counters = {"launches": dict(launches, blind_rotate_ks_fused=10, keyswitch=10),
                "samples": dict(launches, blind_rotate_ks_fused=2560, keyswitch=2560)}
    kernels = [("void blind_rotate_kernel<10, 2, 2>(...)", 0.00635)] * 10 + \
              [("ks_mma_kernel", 0.0002)] * 10 + [("elementwise", 0.0001)] * 30
    s = _summary(kernels, 0.07)
    jobs = [H.Job(0.007 * i, 0.007 * (i + 1), 256) for i in range(10)]
    run = _run("gates-b256", jobs, 0.07, trace=s, counters=counters, ranks=[s])
    bound = roofline.blind_rotate_bound_s(PARAMS_110, 10, 2560, fused_ks=True)
    assert H.reader("k4.roofline_pct")(run) == pytest.approx(100 * bound / 0.0655)
    assert H.reader("gates.glue_pct")(run) == pytest.approx(100 * 0.003 / 0.0685)
    assert H.reader("gates.idle_pct")(run) == pytest.approx(100 * (1 - 0.0685 / 0.07))
    assert H.reader("dp4.collective_pct")(run) is None         # one rank
    assert H.reader("k5.roofline_pct")(run) is None            # no K5 launch
    assert H.reader("serial.kernels_per_op")(run) == pytest.approx(5.0)
    skew = [_summary([("k", 1.0), ("ncclDevKernel_AllGather", 0.2)], 2.0),
            _summary([("k", 1.01), ("ncclDevKernel_AllGather", 0.1)], 2.0)]
    run4 = _run("gates-dp4-b16384", jobs, 0.07, trace=skew[0], counters=counters, ranks=skew)
    assert H.reader("dp4.rank_skew_pct")(run4) == pytest.approx(1.0)
    assert H.reader("dp4.collective_pct")(run4) == pytest.approx(10.0)


def test_readers_find_nothing_without_a_trace():
    jobs = [H.Job(0.0, 1.0, 256)]
    run = _run("gates-b256", jobs, 1.0)
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert H.reader(m["name"])(run) is None, m["name"]


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert callable(H.reader(m["name"]))
    for w in BENCH["workloads"]:
        assert H.config(w["config"])["name"] == w["config"]
        assert H.traffic(w["traffic"])["kind"]
        e2e = H.metrics_of(BENCH, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert H.metrics_of(BENCH, w["name"], "per_layer")
    assert not math.isnan(roofline.HBM_BYTES_PER_S)
