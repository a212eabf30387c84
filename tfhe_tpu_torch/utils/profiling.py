"""Timing and profiling helpers.

Port of ``tfhe_tpu.utils.profiling``. The reference brackets every experiment
with omp_get_wtime() (main.cu:929-934) and splits gate time into
bootstrapping / key switch / misc (paper Table IV). PyTorch returns before
the card has finished, so every time here ends at a synchronise: on a CUDA
device a span lies between two CUDA events on the current stream (the work
queued inside it, whatever the host did meanwhile), on the CPU between two
readings of the host clock. ``device_trace`` records a ``torch.profiler``
trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def _span(device: torch.device, out: list):
    """Appends to `out` the seconds the body's work took on `device`."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end) / 1e3)
    else:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            out.append(time.perf_counter() - t0)


@dataclass
class PhaseTimer:
    """Accumulates the time of named phases on one device, each synchronised
    at its end."""
    device: torch.device
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = torch.device(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        took: list = []
        try:
            with _span(self.device, took):
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + took[0]
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} total {tot*1e3:9.2f} ms   n={n}   avg {tot/n*1e3:9.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the body (host and, where there is a
    card, device activity) into `logdir`/trace.json, in the Chrome trace
    format (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn, *args, device, iters: int = 5, warmup: int = 1):
    """Warm up, then time `iters` calls of fn(*args) whose work runs on
    `device`. Returns (seconds per call, last result)."""
    device = torch.device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    took: list = []
    with _span(device, took):
        for _ in range(iters):
            out = fn(*args)
    return took[0] / iters, out
