"""The control and the faults that prove the checks of ``run.py`` can fail.

Neither is part of a benchmark run: the tests and the command below install
one of them into the program, drive a whole run through ``run.execute``, and
expect ``correct`` to come out false.

- ``control``: the plain reference put in the program's place, computed in
  float32 (TF32 off), the nearest precision below the exact integer
  arithmetic the configurations state: every bootstrap of the program (the
  fused route and the route without key switch) is the reference's, with its
  external products and key switch rounded to float32.
- ``unchanged``: the blind rotate returns its accumulator unchanged (its
  plain version; the tests run it on the CPU).
- ``half``: a bootstrap computes the first half of its batch and repeats it
  over the second.
- ``altered``: every bootstrap's first answer has its message negated.
- ``no_exchange``: the all-gather between ranks returns the rank's own part
  in every slot.

On the card, the control at a cell's own size, one seed after another:

    python3 h100_bench/control.py --workload <cell> --seconds <s> --seeds <n> ...

prints each seed's numbers compared, beside their limits, and `correct`.
"""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import torch

import keys as K
import reference as ref

FAULTS = ("control", "unchanged", "half", "altered", "no_exchange")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def installed(fault: str):
    """The program with `fault` in place, for the body."""
    from tfhe_tpu_torch.core import bootstrap as bs
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    from tfhe_tpu_torch.parallel import mesh

    with contextlib.ExitStack() as stack:
        if fault == "control":
            made = {}
            keygen = K.keygen

            def keygen_kept(params, seed, device):
                made["keys"] = keygen(params, seed, device)
                return made["keys"]

            def whole(x, mu, cloud):
                a, b = ref.bootstrap(made["keys"], x.a, x.b, mu, dtype=torch.float32)
                return LweCiphertext(a, b, torch.zeros_like(x.b, dtype=torch.float32))

            def woks(x, mu, cloud):
                a, b = ref.rotate_extract(made["keys"], x.a, x.b, mu, dtype=torch.float32)
                return K.wrap32(a), K.wrap32(b), torch.zeros_like(x.b, dtype=torch.float32)

            from tfhe_tpu_torch import arith, config
            stack.enter_context(_patched(K, "keygen", keygen_kept))
            stack.enter_context(_patched(bs, "_bootstrap_whole", whole))
            stack.enter_context(_patched(bs, "_bootstrap_woks_whole", woks))
            # the reference's bootstrap is not captured into a graph, and
            # warms no graph: every circuit call is eager
            stack.enter_context(config.overrides(TFHE_TPU_CIRCUIT_JIT="0"))
            stack.enter_context(_patched(arith, "CAPTURE_AFTER", 0))
            stack.enter_context(_patched(torch.backends.cuda.matmul, "allow_tf32", False))
        elif fault == "unchanged":
            stack.enter_context(_patched(bs, "blind_rotate",
                                         lambda acc, bara, bk, sh, params: acc))
        elif fault in ("half", "altered"):
            whole_of = bs._bootstrap_whole

            def faulty(x, mu, cloud):
                out = whole_of(x, mu, cloud)
                if fault == "altered":
                    b = out.b.clone()
                    b[0] += 1 << 31
                    return LweCiphertext(out.a, b, out.cv)
                B = out.b.shape[0]
                keep = (B + 1) // 2
                idx = torch.arange(B, device=out.b.device) % keep
                return LweCiphertext(out.a[idx], out.b[idx], out.cv[idx])

            stack.enter_context(_patched(bs, "_bootstrap_whole", faulty))
        elif fault == "no_exchange":
            stack.enter_context(_patched(
                mesh, "all_gather_cat",
                lambda t, group, size, m: torch.cat([t] * size)))
        else:
            raise ValueError(f"unknown fault {fault!r}")
        yield


def _rank_entry(fault: str, rank: int, world: int, port: int, args: dict) -> None:
    """A spawned rank of a run with `fault` installed."""
    import run
    with installed(fault):
        run.rank_entry(rank, world, port, args)


def run_with(fault: str, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             device, params=None) -> dict:
    """A whole run with `fault` installed (in every rank of a cell of several
    chips); returns run.execute's record."""
    import functools
    import run
    with installed(fault):
        if cell["chips"] > 1:
            return run.execute_ranks(cell, cfg, traffic, seed, seconds, False, cell["chips"],
                                     device=None if device == "cuda" else device,
                                     params=params, entry=functools.partial(_rank_entry, fault))
        return run.execute(cell, cfg, traffic, seed, seconds, False, device, params=params)


def main(argv=None) -> int:
    import harness as H
    ap = argparse.ArgumentParser(description="The control of a cell, on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="control", choices=FAULTS)
    args = ap.parse_args(argv)
    bench = H.benchmark()
    cell = H.cell(bench, args.workload)
    cfg, traffic = H.config(cell["config"]), H.traffic(cell["traffic"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("control: needs the cell's CUDA cards", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_with(args.fault, cell, cfg, traffic, seed, args.seconds, "cuda")
        correct = all(c["value"] <= c["limit"] for c in out["checks"])
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": correct, "attempted": len(out["jobs"]),
                          "failed": out["failed"], "info": out["info"],
                          "checks": out["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
