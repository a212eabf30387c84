"""Multi-rank dry run: every sharding shape of the port once, with decrypted values checked.

    python -m tfhe_tpu_torch.parallel.dryrun N [--device cpu]

spawns N processes (``torch.multiprocessing``, spawn start method), joins
them into one process group through a file in a temporary directory, and runs
on each rank the six shapes of ``tfhe_tpu``'s multi-chip dry run
(``__graft_entry__.dryrun_multichip``), each result decrypted against the
plaintext on every rank:

  1. 1-D DP AND over all ranks (PARAMS_SMALL_NOISY, 8 gates a rank);
  2. dp x ks XOR with the key-switch table split over ks (4, 2 or 1: the
     largest that divides N);
  3. Cannon's algorithm on a 2 x 2 grid, 4-bit matrices (N >= 4);
  4. 1-D DP AND at PARAMS_110 with the reference's keys, 2 gates a rank;
  5. a whole 16-bit multiply, data-parallel, one number a rank;
  6. dp x ks AND at PARAMS_110, 8 gates a rank.

The ranks run on the card unless ``--device cpu`` is given: with one card a
rank, over NCCL; several ranks sharing a card, or the CPU, over gloo (see
``mesh``). A rank that raises fails the run. N ranks sharing one card give a
correctness check of the sharded entry points, not a scaling number.

NCCL's bootstrap finds its peers over a socket. Unless the environment names
an interface, the ranks name the loopback (``NCCL_SOCKET_IFNAME=lo``): the
ranks of one host need no network, and a host without one has no other
interface to offer.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

SEED = (314, 1592, 657)


def rank_environ(env) -> None:
    """The environment a spawned rank adds: NCCL's bootstrap on the loopback
    where `env` names no interface (an interface it names stays)."""
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")


def _rank_main(rank: int, world: int, tmp: str, device, threads, fn, args) -> None:
    import torch.distributed as dist
    from .mesh import init_process
    rank_environ(os.environ)
    torch.set_num_threads(threads)
    dev = init_process(rank, world, "file://" + os.path.join(tmp, "rendezvous"), device)
    try:
        out = fn(rank, world, dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        # under NCCL the barrier runs on this rank's card, named, not guessed
        dist.barrier(device_ids=[dev.index] if dist.get_backend() == "nccl" else None)
    finally:
        dist.destroy_process_group()


def run(world: int, fn, *args, device=None, threads: int | None = None) -> list:
    """fn(rank, world, device, *args) on each of `world` spawned processes
    joined into one process group; returns the ranks' results in rank order.
    fn must be importable by name (a module-level function) and its results
    picklable. threads: torch threads a rank (default: the cores over the
    ranks). An exception in any rank raises here. Each rank sets
    NCCL_SOCKET_IFNAME=lo where the environment leaves it unset
    (``rank_environ``)."""
    import torch.multiprocessing as mp
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="tfhe_tpu_torch_dryrun_") as tmp:
        mp.spawn(_rank_main, args=(world, tmp, device, threads, fn, args), nprocs=world,
                 join=True)
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs


def _setup(params, batch: int, device, reference: bool = False):
    """Keys (the reference's at PARAMS_110, else keygen from SEED) and two
    encrypted random bit batches: the same on every rank."""
    import tfhe_tpu_torch as tt
    sk = (tt.keygen_reference(params, seed=SEED, device=device) if reference
          else tt.keygen(params, seed=SEED, device=device))
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2, size=batch).astype(np.int32)
    b = rng.randint(0, 2, size=batch).astype(np.int32)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return sk, a, b, tt.encrypt_bits(sk, a, gen, device), tt.encrypt_bits(sk, b, gen, device)


def _expect(got, want, what: str) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: decrypts to {got}, want {want}")


def dryrun_multichip(rank: int, world: int, device, shapes=(1, 2, 3, 4, 5, 6)) -> list:
    """The shapes of the module docstring on this rank (every rank of the
    world calls this with the same arguments); returns the lines rank 0
    prints."""
    import tfhe_tpu_torch as tt
    from tfhe_tpu_torch import arith
    from .mesh import make_mesh, make_mesh2d_dp_ks, sharded_circuit, sharded_gate2, \
        sharded_gate2_tp_ks
    from .cannon import cannon_matmul_mesh, make_mesh2d

    lines = []
    n = world
    batch = 8 * n
    ks = max(d for d in (4, 2, 1) if n % d == 0)
    mesh = make_mesh(n, device=device)
    mesh2 = make_mesh2d_dp_ks(n // ks, ks, device=device) if ks > 1 else None
    grid = make_mesh2d(2, device=device) if n >= 4 else None
    sk, a, b, ca, cb = _setup(tt.PARAMS_SMALL_NOISY, batch, device)

    if 1 in shapes:
        out = sharded_gate2("AND", ca, cb, sk.cloud, mesh)
        _expect(tt.decrypt_bits(sk, out), a & b, "1-D DP AND")
        lines.append(f"dryrun[1/6] 1-D DP AND over {n} ranks ({mesh.backend} on "
                     f"{mesh.device}), batch {batch}: values OK")
    if 2 in shapes:
        if mesh2 is None:
            lines.append("dryrun[2/6] skipped (needs a world divisible by 2)")
        else:
            out = sharded_gate2_tp_ks("XOR", ca, cb, sk.cloud, mesh2)
            _expect(tt.decrypt_bits(sk, out), a ^ b, "dp x ks XOR")
            lines.append(f"dryrun[2/6] 2-D dp x ks ({n // ks}x{ks}) XOR with the key switch "
                         f"split over ks: values OK")
    if 3 in shapes:
        if grid is None:
            lines.append("dryrun[3/6] skipped (needs >= 4 ranks)")
        else:
            ma = np.array([[1, 2], [0, 3]], np.int64)
            mb = np.array([[2, 1], [1, 1]], np.int64)
            gen = torch.Generator(device=device)
            gen.manual_seed(63)
            cma = arith.encrypt_int(sk, ma, 4, gen, device)
            cmb = arith.encrypt_int(sk, mb, 4, gen, device)
            out = cannon_matmul_mesh(cma, cmb, sk.cloud, grid)
            if out is not None:
                _expect(arith.decrypt_int(sk, out), ma @ mb, "Cannon 2x2")
            lines.append("dryrun[3/6] Cannon 2x2 grid matmul: values OK")
    if 4 in shapes:
        sk110, a110, b110, ca110, cb110 = _setup(tt.PARAMS_110, 2 * n, device, reference=True)
        out = sharded_gate2("AND", ca110, cb110, sk110.cloud, mesh)
        _expect(tt.decrypt_bits(sk110, out), a110 & b110, "1-D DP AND at PARAMS_110")
        lines.append(f"dryrun[4/6] 1-D DP AND at PARAMS_110 (n=500, N=1024) over {n} ranks, "
                     f"batch {2 * n}: values OK")
    if 5 in shapes:
        rng = np.random.RandomState(5)
        mv_a = rng.randint(0, 1 << 15, size=n)
        mv_b = rng.randint(0, 1 << 15, size=n)
        gen = torch.Generator(device=device)
        gen.manual_seed(65)
        cm_a = arith.encrypt_int(sk, mv_a, 16, gen, device)
        cm_b = arith.encrypt_int(sk, mv_b, 16, gen, device)
        out = sharded_circuit(arith.mul, (cm_a, cm_b), sk.cloud, mesh)
        _expect(arith.decrypt_int(sk, out, signed=False), (mv_a * mv_b) % (1 << 16),
                "whole-circuit DP 16-bit multiply")
        lines.append(f"dryrun[5/6] whole-circuit DP 16-bit multiply, 1 number a rank over "
                     f"{n} ranks: values OK")
    if 6 in shapes:
        if mesh2 is None:
            lines.append("dryrun[6/6] skipped (needs a world divisible by 2)")
        else:
            sk6, a6, b6, ca6, cb6 = _setup(tt.PARAMS_110, 8 * n, device, reference=True)
            out = sharded_gate2_tp_ks("AND", ca6, cb6, sk6.cloud, mesh2)
            _expect(tt.decrypt_bits(sk6, out), a6 & b6, "dp x ks AND at PARAMS_110")
            lines.append(f"dryrun[6/6] 2-D dp x ks ({n // ks}x{ks}) AND at PARAMS_110, batch "
                         f"{8 * n} (8 a rank) with the key switch split over ks: values OK")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int, help="processes to spawn")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the ranks on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    for line in run(args.ranks, dryrun_multichip, device=args.device)[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
