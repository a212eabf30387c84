"""Run one cell of the benchmark of tfhe_tpu_torch once, on the card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and metrics
are found by name (``harness``). The run makes its keys and inputs from the
seed, warms up every shape the window uses, sends the cell's traffic for
`seconds` (a closed loop, each request synchronised), then judges every
answer against the plain reference and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, the metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics, read from a
torch.profiler trace of the window), the device and the numbers compared
beside their limits. A cell of several chips runs one process a card, rank 0
in this process, over NCCL; every rank evaluates the whole traffic and rank
0 times it and reports.

It runs only on the card: without CUDA, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse
import collections
import os
import socket
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import torch

import harness as H
import keys as K
import devtrace as T
from sender import Context


def params_of(cfg: dict):
    from tfhe_tpu_torch.params import TfheParams
    return TfheParams(**cfg["params"])


def bench_params(P) -> K.Params:
    return K.Params(P.n, P.N, P.k, P.bk_l, P.bk_Bgbit, P.ks_basebit, P.ks_t, P.ks_stdev,
                    P.bk_stdev)


def _counters() -> dict:
    from tfhe_tpu_torch.ops import cmux
    return {"launches": dict(cmux.LAUNCHES), "samples": dict(cmux.SAMPLES)}


def _delta(before: dict, after: dict) -> dict:
    return {k: {n: after[k][n] - before[k][n] for n in after[k]} for k in after}


def _barrier(mesh, device):
    if mesh is not None:
        import torch.distributed as dist
        # under NCCL the barrier runs on this rank's card, named, not guessed
        dist.barrier(device_ids=[device.index] if dist.get_backend() == "nccl" else None)


def _stop(done: bool, ctl, rank: int) -> bool:
    """Rank 0's clock decides when the window closes, for every rank: over
    `ctl`, a group of the hosts (gloo), so that no rank waits on its card."""
    if ctl is None:
        return done
    import torch.distributed as dist
    flag = torch.tensor([int(done and rank == 0)])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctl)
    return bool(flag.item())


def _reserve(answer: list, count: int) -> None:
    """Hold, then free, room for `count` answers shaped like `answer`, so that
    keeping the window's answers for the checks finds the caching allocator's
    blocks ready: a cudaMalloc in the window stalls the card for tens of ms."""
    held = [torch.empty_like(t) for _ in range(count) for t in answer]
    del held


def _event(device):
    """A marker of the work enqueued so far on the device's stream."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _complete(entry, t0: float) -> H.Job:
    """Wait for a request's work; its job, with the host's clock at its end."""
    ts, ev, units, kind = entry
    if ev is not None:
        ev.synchronize()
    return H.Job(ts, time.perf_counter() - t0, units, kind)


def execute(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
            device, rank: int = 0, world: int = 1, t_start: float | None = None,
            params=None) -> dict | None:
    """One rank's run: keys, inputs, warm-up, the window, and (rank 0) the
    checks. Returns rank 0's record, None on the other ranks. `params`
    replaces the configuration's parameter set (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases, last = {}, [t_start]

    def lap(name: str) -> None:
        """The seconds of a phase of set-up, to its end from the last's."""
        now = time.perf_counter()
        phases[name] = round(now - last[0], 3)
        last[0] = now

    lap("start")
    device = torch.device(device)
    torch.zeros(1, device=device)
    lap("context")
    P = params or params_of(cfg)
    keys = K.keygen(bench_params(P), seed, device)
    lap("keys")
    from tfhe_tpu_torch.core.keys import cloud_from_raw
    cloud = cloud_from_raw(P, keys.bk.cpu().numpy(), keys.ks_a.cpu().numpy(),
                           keys.ks_b.cpu().numpy(), device)
    lap("cloud_from_raw")
    mesh = ctl = None
    if world > 1:
        import torch.distributed as dist
        from tfhe_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(world, device=device)
        ctl = dist.new_group(backend="gloo")
        lap("mesh")
    ctx = Context(device, seed, traffic, keys, cloud, mesh)
    sender = H.sender(traffic["kind"]).Sender(ctx)
    sender.setup()
    lap("inputs")
    answer, per_request = sender.warm()
    lap("warm")
    depth = traffic.get("depth", 1)
    _reserve(answer, int(1.25 * seconds / per_request) + 2 * depth + sender.block)
    _barrier(mesh, device)
    lap("reserve")
    setup_s = time.perf_counter() - t_start
    holder: dict = {}
    jobs, pending = [], collections.deque()
    before = _counters()
    with T.profiled(trace, holder):
        t0 = time.perf_counter()
        i, done = 0, False
        while not done:
            ts = time.perf_counter() - t0
            units, kind = sender.step(i)
            pending.append((ts, _event(device), units, kind))
            i += 1
            if len(pending) >= depth:
                jobs.append(_complete(pending.popleft(), t0))
                # the window closes after a whole block of the traffic's
                # requests, so that every run does the same work
                done = _stop(jobs[-1].end >= seconds and len(jobs) % sender.block == 0, ctl, rank)
        while pending:
            jobs.append(_complete(pending.popleft(), t0))
    counters = _delta(before, _counters())
    _barrier(mesh, device)
    summary = T.summarize(holder["prof"]) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the program's state goes before the reference runs: its keys and graphs
    from tfhe_tpu_torch import arith
    arith.GRAPHS.entries.clear()
    ctx.cloud = cloud = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rank_digests = None
    if mesh is not None:
        import torch.distributed as dist
        mine = {"digests": sender.digests(), "trace": T.slim(summary), "peak": peak}
        everyone = [None] * world
        dist.all_gather_object(everyone, mine)
        if rank != 0:
            return None
        rank_digests = [e["digests"] for e in everyone]
        peaks = [e["peak"] for e in everyone]
        traces = [e["trace"] for e in everyone]
    else:
        peaks, traces = [peak], [T.slim(summary)]

    checks, failed, info = sender.check(rank_digests)
    return {"setup_s": setup_s, "setup_phases": phases, "jobs": jobs, "counters": counters,
            "summary": summary, "traces": traces, "peak": max(peaks), "checks": checks,
            "failed": failed, "info": info, "world": world}


def report(bench: dict, cell: dict, cfg: dict, traffic: dict, out: dict, trace: bool,
           device_kind: str) -> str:
    """The result line of a run."""
    jobs = out["jobs"]
    run = H.Run(cell=cell, traffic=traffic, config=cfg, setup_s=out["setup_s"],
                window_s=jobs[-1].end if jobs else 0.0, jobs=jobs, counters=out["counters"],
                trace=out["summary"], ranks=out["traces"])
    section = "per_layer" if trace else "end_to_end"
    listed = H.metrics_of(bench, cell["name"], section)
    metrics = H.read_metrics(run, [m["name"] for m in listed])
    units = {m["name"]: m["unit"] for m in listed}
    device = {"platform": "gpu", "kind": device_kind, "count": out["world"],
              "memory_peak_bytes": out["peak"]}
    breakdown = None
    if trace:
        busy = [t["busy_s"] for t in out["traces"] if t]
        device["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        device["window_s"] = out["summary"]["window_s"] if out["summary"] else run.window_s
        breakdown = T.breakdown(out["summary"]) if out["summary"] else None
    correct = all(c["value"] <= c["limit"] for c in out["checks"])
    return H.result_line(correct, len(jobs), out["failed"], metrics, units, device,
                         out["checks"], breakdown)


def rank_entry(rank: int, world: int, port: int, args: dict) -> None:
    """A rank other than 0 of a cell of several chips (a spawned process)."""
    torch.set_num_threads(2)
    from tfhe_tpu_torch.parallel.mesh import init_process
    device = init_process(rank, world, f"tcp://127.0.0.1:{port}", args["device"])
    import torch.distributed as dist
    try:
        execute(args["cell"], args["cfg"], args["traffic"], args["seed"], args["seconds"],
                args["trace"], device, rank=rank, world=world, params=args["params"])
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def execute_ranks(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
                  trace: bool, world: int, device=None, t_start: float | None = None,
                  params=None, entry=rank_entry) -> dict:
    """A run of `world` ranks: ranks 1.. in spawned processes (`entry`, a
    module-level function), rank 0 here. Each rank is on card `rank` over
    NCCL, or on the CPU over gloo where `device` is "cpu". Raises if a rank
    fails."""
    import multiprocessing as mp
    from tfhe_tpu_torch.parallel.mesh import init_process
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    port = _free_port()
    shared = {"cell": cell, "cfg": cfg, "traffic": traffic, "seed": seed, "seconds": seconds,
              "trace": trace, "device": device, "params": params}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=entry, args=(r, world, port, shared)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        dev = init_process(0, world, f"tcp://127.0.0.1:{port}", device)
        import torch.distributed as dist
        try:
            out = execute(cell, cfg, traffic, seed, seconds, trace, dev, world=world,
                          t_start=t_start, params=params)
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank failed (exit codes {[p.exitcode for p in procs]})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = H.benchmark()
    cell = H.cell(bench, args.workload)
    cfg, traffic = H.config(cell["config"]), H.traffic(cell["traffic"])
    world = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"h100_bench: the cell needs {world} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    trace = bool(args.trace)
    if world > 1:
        out = execute_ranks(cell, cfg, traffic, args.seed, args.seconds, trace, world,
                            t_start=T_START)
    else:
        out = execute(cell, cfg, traffic, args.seed, args.seconds, trace,
                      torch.device("cuda", 0), t_start=T_START)
    line = report(bench, cell, cfg, traffic, out, trace, torch.cuda.get_device_name(0))
    found = H.forbidden_modules()
    if found:
        print(f"h100_bench: the measured process loaded {found}", file=sys.stderr)
        return 3
    print(f"h100_bench: {args.workload} seed {args.seed}: setup {out['setup_s']:.3f} s "
          f"{out['setup_phases']}, "
          f"{len(out['jobs'])} requests, {out['info']}", file=sys.stderr)
    H.print_checks(out["checks"])
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
