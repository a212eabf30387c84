"""Cannon's algorithm over a d x d grid of ranks, one matrix element a rank.

Port of ``tfhe_tpu.parallel.cannon``. The reference simulates the block grid
on one GPU with leftRotate/upRotate kernels (`gpuParallel/main.cu:2590-2644,
2531-2557`); ``tfhe_tpu`` puts one element on each chip and rotates with
``ppermute`` over the mesh. Here each element lives on a rank, and each
rotation is a ring shift by ``dist.batch_isend_irecv`` along the rank's row
or column of the grid.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import arith
from ..core.lwe import LweCiphertext
from .mesh import Mesh, _grid, _host, all_gather_cat


def make_mesh2d(d: int, axis_names=("mr", "mc"), device=None) -> Mesh:
    """A d x d grid of the first d*d ranks: rank r sits at (r // d, r % d)."""
    return _grid((d, d), tuple(axis_names), device)


def _pack(ct: LweCiphertext) -> torch.Tensor:
    """a, b and cv (its float32 bits) in one int32 buffer: one message a shift."""
    return torch.cat([ct.a.reshape(-1), ct.b.reshape(-1),
                      ct.cv.contiguous().view(torch.int32).reshape(-1)])


def _unpack(buf: torch.Tensor, like: LweCiphertext) -> LweCiphertext:
    na, nb = like.a.numel(), like.b.numel()
    return LweCiphertext(buf[:na].reshape(like.a.shape), buf[na:na + nb].reshape(like.b.shape),
                         buf[na + nb:].view(torch.float32).reshape(like.cv.shape))


def ring_shift(ct: LweCiphertext, mesh: Mesh, axis: str, by: int) -> LweCiphertext:
    """Along `axis`, the rank at position p takes the block of position
    (p + by) % d (``ppermute`` with pairs (i, (i - by) % d))."""
    line = mesh.line_ranks[axis]
    d = len(line)
    if by % d == 0:
        return ct
    p = mesh.coords[mesh.axis_names.index(axis)]
    send = _host(_pack(ct), mesh)
    recv = torch.empty_like(send)
    group = mesh.groups[axis]
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, line[(p - by) % d], group),
        dist.P2POp(dist.irecv, recv, line[(p + by) % d], group)])
    for w in works:
        w.wait()
    return _unpack(recv.to(ct.a.device), ct)


def cannon_matmul_mesh(a: LweCiphertext, b: LweCiphertext, cloud, mesh: Mesh):
    """Element-grid Cannon matmul of encrypted matrices a, b: [D, D, nbits]
    on a D x D grid; every rank of the grid returns the [D, D, nbits] product
    (None off the grid). Rank (i, j) holds element (i, j) as a [1, 1, nbits]
    block; the skew takes log2(D) conditional hops as ``tfhe_tpu``'s does,
    then D rounds of ``arith.mul`` and ``arith.add`` with shifts between."""
    d = mesh.shape[0]
    if mesh.shape != (d, d) or tuple(a.batch_shape[:2]) != (d, d) \
            or tuple(b.batch_shape[:2]) != (d, d):
        raise ValueError(f"a {d} x {d} grid takes {d} x {d} matrices, got "
                         f"{a.batch_shape[:2]} and {b.batch_shape[:2]} on {mesh.shape}")
    if mesh.coords is None:
        return None
    mr, mc = mesh.axis_names
    i, j = mesh.coords
    a_sk, b_sk = a[i:i + 1, j:j + 1], b[i:i + 1, j:j + 1]
    # the skew: row i of A left by i, column j of B up by j
    step = 1
    while step < d:
        a_hop, b_hop = ring_shift(a_sk, mesh, mc, step), ring_shift(b_sk, mesh, mr, step)
        a_sk = a_hop if (i // step) % 2 == 1 else a_sk
        b_sk = b_hop if (j // step) % 2 == 1 else b_sk
        step *= 2
    acc = None
    for r in range(d):
        prod = arith.mul(a_sk, b_sk, cloud)
        acc = prod if acc is None else arith.add(acc, prod, cloud)
        if r + 1 < d:
            a_sk, b_sk = ring_shift(a_sk, mesh, mc, 1), ring_shift(b_sk, mesh, mr, 1)
    blocks = [all_gather_cat(v, mesh.group, mesh.size, mesh) for v in (acc.a, acc.b, acc.cv)]
    return LweCiphertext(*(v.reshape((d, d) + tuple(v.shape[2:])) for v in blocks))
