"""What every cell shares: the files a cell is made of, found by name, the
record of a run that the metric readers read, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<config>.json`` (the parameter set, the deployment
and the guarantees it states); the traffic is ``workloads/<traffic>.json``,
whose ``kind`` names the sender ``senders/<kind>.py`` that sends it and whose
other keys are that sender's parameters and the limits of its checks. Each
metric, end-to-end or per-layer, is read by ``metrics/<metric>.py``: a
function ``read(run)`` that returns a number, or None where the run holds
nothing for it to read. Adding a configuration, a cell, a traffic kind or a
metric adds files and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that must not be loaded in a measured process, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "tfhe_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` that the cell reports: those that list it
    under ``workloads``, and those that list no workloads."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def _load(folder: str, name: str):
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The function that reads `metric` from a run."""
    return _load("metrics", metric).read


def sender(kind: str):
    """The module of traffic kind `kind`; its ``Sender`` sends the traffic."""
    return _load("senders", kind)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Job:
    """One request of a closed loop: host-clock start and end (seconds from
    the window's start), the work it held (gates, ops or matmuls) and its kind."""
    start: float
    end: float
    units: int
    kind: str = ""


@dataclass
class Run:
    """What a run leaves for the metric readers."""
    cell: dict
    traffic: dict
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0               # host clock, window start to the last completed job
    jobs: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)   # program counters over the window
    trace: dict | None = None           # devtrace.summarize() of the traced window (rank 0)
    ranks: list = field(default_factory=list)      # each rank's trace summary (multi-card)

    @property
    def units(self) -> int:
        return sum(j.units for j in self.jobs)


def read_metrics(run: Run, names: list) -> dict:
    """{name: value} for each metric whose reader finds something to read."""
    out = {}
    for name in names:
        value = reader(name)(run)
        if value is not None:
            out[name] = value
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, units: dict,
                device: dict, checks: list, breakdown: dict | None = None) -> str:
    """The last line of standard output: the result a check reads."""
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def print_checks(checks: list) -> None:
    """The numbers compared, each beside its limit: the last lines of stderr."""
    for c in checks:
        print(f"check {c['name']} = {c['value']} (limit {c['limit']}: "
              f"{'pass' if c['value'] <= c['limit'] else 'FAIL'})", file=sys.stderr, flush=True)
