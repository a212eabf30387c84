"""The reduction of a torch.profiler trace of the measured window to what the
per-layer metrics read: the device's kernels, its busy time, the longest idle
gaps and what the host was doing in each (from the benchmark's own spans and
the host's operations in the same trace)."""
from __future__ import annotations

import contextlib

import torch

WINDOW = "bench.window"     # the benchmark's span around the traced window
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool, holder: dict):
    """Profile the body when `enabled` (host and device activity); the
    profiler is left in holder["prof"]."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder["prof"] = prof


def _union(spans):
    busy, edge = 0.0, None
    for s, e in spans:
        if edge is None or s > edge:
            busy += e - s
            edge = e
        elif e > edge:
            busy += e - edge
            edge = e
    return busy


def summarize(prof) -> dict | None:
    """Kernels and host spans of the traced window, in seconds; None where
    the profiler recorded no device activity."""
    kernels, host, window = [], [], None
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the benchmark's own spans are mirrored on the device's
            # timeline as annotations: they are no kernels
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith("bench.")):
                kernels.append((start, end, ev.name))
        elif ev.name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, ev.name))
    if window is None or not kernels:
        return None
    w0, w1 = window
    kernels = sorted((max(s, w0), min(e, w1), n) for s, e, n in kernels if e > w0 and s < w1)
    if not kernels:
        return None
    busy = _union((s, e) for s, e, _ in kernels)
    by_name: dict = {}
    for s, e, n in kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, edge = [], w0
    for s, e, _ in kernels:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host.sort()
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named.append([min(inside)[1] if inside else "host: python", (g1 - g0) / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": [(n, (e - s) / 1e6) for s, e, n in kernels],
        "by_name": {n: t / 1e6 for n, t in by_name.items()},
        "idle_gaps": named,
    }


def breakdown(summary: dict) -> dict:
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, t] for n, t in top], "idle_gaps": summary["idle_gaps"]}


def slim(summary: dict | None) -> dict | None:
    """A summary without its kernel list, small enough to send between ranks."""
    if summary is None:
        return None
    return {k: v for k, v in summary.items() if k != "kernels"}


def kernel_s(summary: dict | None, *needles: str) -> float | None:
    """Device seconds of the kernels whose names hold any of `needles`."""
    if summary is None:
        return None
    return sum(t for n, t in summary["by_name"].items() if any(s in n for s in needles))


def idle_pct(summary: dict | None) -> float | None:
    """The share of the traced window in which no kernel ran."""
    if summary is None:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])

