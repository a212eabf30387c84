"""Timing and profiling helpers, and the program's spans.

Port of ``tfhe_tpu.utils.profiling``. The reference brackets every experiment
with omp_get_wtime() (main.cu:929-934) and splits gate time into
bootstrapping / key switch / misc (paper Table IV). PyTorch returns before
the card has finished, so every time of ``PhaseTimer`` ends at a synchronise:
on a CUDA device a phase lies between two CUDA events on the current stream
(the work queued inside it, whatever the host did meanwhile), on the CPU
between two readings of the host clock. ``device_trace`` records a
``torch.profiler`` trace.

``span(name, **attrs)`` marks one layer's boundary inside the program
(``tfhe.gate2``, ``tfhe.bootstrap``, ``tfhe.kernel.<wrapper>``,
``tfhe.circuit``, ...). It records only while a ``torch.profiler`` records
(``device_trace``, a traced benchmark run); otherwise it costs one check of
``torch.autograd._profiler_enabled()`` and returns a shared object that does
nothing. While the profiler records, a span enters
``torch.profiler.record_function(name)``, so it lands in the profiler's trace
beside the kernels it launches, and at its end keeps a record in this
module's store: its id, its parent's (the span open around it on this
thread), its root's (the outermost span of the call: one id per request),
its start and end on ``time.perf_counter_ns()``, its attributes and its
children's time. ``spans()`` returns the store as ``SpanRecord``s,
``span_counts()`` every span by name, ``reset_spans()`` empties both. The
store keeps the first ``SPAN_CAP`` = 100,000 spans to close (some 25 MB; a
30-second traced window of 256-gate calls holds about 25,000); past it,
spans are counted and not kept.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def _elapsed(device: torch.device, out: list):
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
            with _elapsed(self.device, took):
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
    format (chrome://tracing, Perfetto). The program's spans (``span``) are
    recorded meanwhile: in the trace, and in ``spans()``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ------------------------------------------------------------------ spans

SPAN_CAP = 100_000

_recording = torch.autograd._profiler_enabled
_STORE: list = []
_COUNTS: collections.Counter = collections.Counter()
_IDS = itertools.count(1)
_LOCK = threading.Lock()        # the store and the counts
_LOCAL = threading.local()      # .open: the spans open on this thread, innermost last


class SpanRecord:
    """One span: name, id, parent id (None at a root), root id, start and end
    (``time.perf_counter_ns``), its attributes, and the nanoseconds of its
    children (``self_ns`` is the rest)."""
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "attrs", "child_ns")

    def __init__(self, name: str, id: int, parent, root: int, start_ns: int, end_ns: int,
                 attrs=None, child_ns: int = 0):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.start_ns, self.end_ns, self.child_ns = start_ns, end_ns, child_ns
        self.attrs = attrs if attrs is not None else {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.duration_ns - self.child_ns

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, attrs={self.attrs})")


class _Span:
    """A span while the profiler records: the profiler's ``record_function``
    around the body, and at its end a flat tuple in the store (its fields,
    then its attributes' keys and values in turn). A tuple of numbers and
    strings leaves the garbage collector's tracking at the first pass that
    sees it (one that holds a tuple of pairs, at the second), so a store of
    tens of thousands of spans does not bring on a full collection, which
    takes ~0.1 s in a process that has imported torch."""
    __slots__ = ("name", "id", "parent", "root", "start_ns", "attrs", "child_ns", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name, self.id, self.attrs = name, next(_IDS), attrs
        self.parent, self.child_ns = None, 0

    def set(self, **attrs) -> None:
        """Adds attributes known only inside the span (a circuit's mode)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_LOCAL, "open", None)
        if stack is None:
            stack = _LOCAL.open = []
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.root = self.id
        stack.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        self._fn = None
        stack = _LOCAL.open
        stack.pop()
        if stack:
            stack[-1].child_ns += end_ns - self.start_ns
        with _LOCK:
            _COUNTS[self.name] += 1
            if len(_STORE) < SPAN_CAP:
                _STORE.append((self.name, self.id, self.parent, self.root, self.start_ns,
                               end_ns, self.child_ns, *itertools.chain(*self.attrs.items())))
        return False


class _NoSpan:
    """What span() returns while no profiler records: nothing, shared."""
    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager around one layer's work: recorded while a
    torch.profiler records, else the shared NO_SPAN. It is falsy when it
    records nothing, so that attributes dear to compute are set only when
    they are kept: ``with span(name) as s: if s: s.set(...)``."""
    if not _recording():
        return NO_SPAN
    return _Span(name, attrs)


def spanned(name: str):
    """A decorator: span(name) around every call of the function."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)
        return wrapper
    return deco


def spans() -> list:
    """The spans recorded since the last reset_spans() (the first SPAN_CAP
    of them to close), as SpanRecords in the order they opened."""
    with _LOCK:
        kept = list(_STORE)
    return [SpanRecord(*t[:6], dict(zip(t[7::2], t[8::2])), t[6])
            for t in sorted(kept, key=lambda t: t[1])]


def span_counts() -> dict:
    """Every span recorded since the last reset_spans(), by name, those past
    SPAN_CAP included."""
    with _LOCK:
        return dict(_COUNTS)


def reset_spans() -> None:
    with _LOCK:
        _STORE.clear()
        _COUNTS.clear()
