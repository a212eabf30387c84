"""Sharding over ranks of ``torch.distributed``: data-parallel gates and
circuits, and a key switch whose table is split over ranks.

Port of ``tfhe_tpu.parallel.mesh``. There a ``jax.sharding.Mesh`` names TPU
chips and ``shard_map`` runs one program on each; here each rank is a
process, and every rank calls every function below with the same global
arguments (global batch in, global batch out, as ``tfhe_tpu``'s signatures
take them). A rank takes its slice of the leading batch axis, computes on
its own device and the slices are gathered back, so every rank returns the
whole result. Keys are replicated.

Axes:
  dp  the gate or ciphertext batch (the reference's bit coalescing, across
      ranks): no traffic until the final gather;
  ks  the rows of the key-switch table (``sharded_gate2_tp_ks``): each rank
      contracts its row block, and one all-reduce sums the partial key switches.

Each rank runs on the card unless the caller asks for the CPU (``rank_device``).
The backend follows where the ranks live (``pick_backend``), and ``Mesh.backend``
is the one that ran:
  NCCL  one rank a card (rank r on card r, as on a host of four H100s joined
        by NVLink): every collective and every ring shift runs on the cards,
        and nothing goes through the host;
  gloo  the CPU, or several ranks sharing one card (NCCL refuses two ranks on
        one device): gloo's collectives take CPU tensors, so the helpers below
        copy a CUDA tensor through the host; the computation stays on the
        rank's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .. import gates
from ..core import bootstrap as bs
from ..core.lwe import LweCiphertext
from ..utils.profiling import span


# ------------------------------------------------------------------ processes

def rank_device(rank: int, device=None) -> torch.device:
    """The device of a rank: `device` when given ("cpu" for the CPU), else
    card number rank % device_count() (the ranks of one host over its cards)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the ranks run on the card unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_process(rank: int, world_size: int, init_method: str, device=None) -> torch.device:
    """Join the process group as `rank` of `world_size` (init_method: a
    ``tcp://`` address or a ``file://`` path) with the backend the rank's
    device calls for; returns that device."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(pick_backend(dev, world_size), init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


# ------------------------------------------------------------------ the mesh

@dataclass
class Mesh:
    """A grid of ranks. `ranks` lists the global ranks in row-major order of
    `shape`; `coords` is this rank's index along each axis (None when this
    rank is not in the grid); `groups[axis]` is the process group of this
    rank's line along `axis` and `line_ranks[axis]` its global ranks; `group`
    spans the whole grid."""
    shape: tuple
    axis_names: tuple
    ranks: tuple
    coords: tuple | None
    device: torch.device
    backend: str
    group: object = None
    groups: dict = field(default_factory=dict)
    line_ranks: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position in the grid, row-major."""
        i = 0
        for c, s in zip(self.coords, self.shape):
            i = i * s + c
        return i


def _grid(shape: tuple, axis_names: tuple, device=None) -> Mesh:
    """The grid of the first prod(shape) ranks. Every rank of the world calls
    this, and so dist.new_group for every line of every axis, in one order."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call init_process first")
    world, me = dist.get_world_size(), dist.get_rank()
    size = 1
    for s in shape:
        size *= s
    if size > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} grid needs {size} ranks, "
                         f"the world has {world}")
    ranks = tuple(range(size))
    coords = None
    if me < size:
        coords, rest = [], me
        for s in reversed(shape):
            coords.append(rest % s)
            rest //= s
        coords = tuple(reversed(coords))
    mesh = Mesh(shape=tuple(shape), axis_names=tuple(axis_names), ranks=ranks, coords=coords,
                device=rank_device(me, device), backend=dist.get_backend())
    mesh.group = dist.group.WORLD if size == world else dist.new_group(list(ranks))
    strides = [1] * len(shape)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    for a, name in enumerate(axis_names):
        # the lines along axis a: every choice of the other coordinates
        others = [r for r in ranks if (r // strides[a]) % shape[a] == 0]
        for base in others:
            line = [base + i * strides[a] for i in range(shape[a])]
            g = dist.new_group(line)
            if me in line:
                mesh.groups[name], mesh.line_ranks[name] = g, tuple(line)
    return mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device=None) -> Mesh:
    """A 1-D mesh of the first n_devices ranks (all of them when None).
    `device` is this rank's (``rank_device``: the card unless "cpu")."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _grid((n,), (axis_name,), device)


def make_mesh2d_dp_ks(dp: int, ks: int, device=None) -> Mesh:
    """A dp x ks grid: rank r sits at (r // ks, r % ks); the ks lines are the
    rows, over which the key-switch table is split."""
    return _grid((dp, ks), ("dp", "ks"), device)


# ------------------------------------------------------------------ collectives

def _host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective takes: gloo's take CPU tensors, so a CUDA
    tensor goes through the host there; NCCL's take the tensor itself."""
    return t.cpu() if mesh.backend == "gloo" and t.device.type == "cuda" else t.contiguous()


# the single-buffer all-gather: all_gather_single where the release has it;
# releases before it (torch 2.11) have only all_gather_into_tensor, which
# later ones deprecate in its favour
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_cat(t: torch.Tensor, group, size: int, mesh: Mesh) -> torch.Tensor:
    """Concatenate along dim 0 the tensors of the `size` ranks of `group`,
    in rank order (every rank's tensor has the same shape), gathered into
    one new buffer. Its span ``tfhe.mesh.all_gather`` gives the bytes
    gathered."""
    with span("tfhe.mesh.all_gather", bytes=size * t.numel() * t.element_size()):
        h = _host(t, mesh)
        out = h.new_empty((size * h.shape[0],) + tuple(h.shape[1:]))
        _gather_single(out, h, group=group)
        return out.to(t.device)


def all_reduce_sum(t: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks of `group`, in place on the card under NCCL."""
    h = _host(t, mesh)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return h.to(t.device)


def _gather_ct(ct: LweCiphertext, group, size: int, mesh: Mesh) -> LweCiphertext:
    return LweCiphertext(*(all_gather_cat(v, group, size, mesh) for v in (ct.a, ct.b, ct.cv)))


def _dp_index(mesh: Mesh, axis: str) -> int:
    if mesh.axis_names != (axis,):
        raise ValueError(f"a 1-D mesh over axis {axis!r} is needed, got axes {mesh.axis_names}")
    return mesh.index


def _slice_ct(ct: LweCiphertext, i: int, parts: int) -> LweCiphertext:
    """Part i of `parts` equal parts of the leading batch axis."""
    B = ct.batch_shape[0]
    if B % parts:
        raise ValueError(f"batch {B} does not divide over {parts} ranks")
    per = B // parts
    return ct[i * per:(i + 1) * per]


# ------------------------------------------------------------------ data parallel

def sharded_gate2(name: str, x: LweCiphertext, y: LweCiphertext, cloud, mesh: Mesh,
                  axis: str = "dp") -> LweCiphertext | None:
    """A 2-input bootstrapped gate with the batch split over the mesh; every
    rank of the mesh returns the whole result (None off the mesh).

    The batch must divide over the mesh. Keys are replicated; each rank
    bootstraps its own slice, and nothing crosses between ranks until the
    gather."""
    if mesh.coords is None:
        return None
    with span("tfhe.mesh.sharded_gate2", kind=name, batch=gates._flat_batch(x), ranks=mesh.size):
        const, ca, cb = gates.GATE_TABLE[name]
        i = _dp_index(mesh, axis)
        xs, ys = _slice_ct(x, i, mesh.size), _slice_ct(y, i, mesh.size)
        out = bs.bootstrap(gates._affine2(xs, ys, const, ca, cb), gates.MU, cloud)
        return _gather_ct(out, mesh.group, mesh.size, mesh)


def sharded_bootstrap_step(x: LweCiphertext, cloud, mesh: Mesh,
                           axis: str = "dp") -> LweCiphertext | None:
    """The gate bootstrap (amplitude MU) of a flat batch split over the mesh."""
    if mesh.coords is None:
        return None
    out = bs.bootstrap(_slice_ct(x, _dp_index(mesh, axis), mesh.size), gates.MU, cloud)
    return _gather_ct(out, mesh.group, mesh.size, mesh)


def sharded_circuit(circuit, cts, cloud, mesh: Mesh, axis: str = "dp") -> LweCiphertext | None:
    """A whole circuit, data-parallel over the mesh: the leading batch axis of
    every input is split, each rank runs circuit(*its slices, cloud) (every
    gate, compressor level and carry chain) with no traffic inside, and the
    results are gathered. circuit: (ct, ..., cloud) -> ct, any circuit whose
    leading axis indexes independent items (all of arith and linalg)."""
    if mesh.coords is None:
        return None
    i = _dp_index(mesh, axis)
    local = [_slice_ct(c, i, mesh.size) for c in cts]
    return _gather_ct(circuit(*local, cloud), mesh.group, mesh.size, mesh)


# ------------------------------------------------------------------ dp x ks

def sharded_gate2_tp_ks(name: str, x: LweCiphertext, y: LweCiphertext, cloud,
                        mesh: Mesh) -> LweCiphertext | None:
    """A 2-input gate on a dp x ks grid: the blind rotate batched over both
    axes, then the key switch with the table's rows split over `ks`.

    Each rank bootstraps its slice without key switch, gathers the batch of
    its ks row, takes its block of extracted coefficients (cols_per of them),
    builds their one-hot digits and multiplies them against its row block of
    ``cloud.ks_table`` (rows (i, j, h-1) over extracted coefficients i, the
    split route's table: ``ks_table_perm`` is regrouped and cannot be split
    so). One int32 all-reduce over the row sums the partial key switches;
    ``ks_finalize`` without digit counts charges the worst-case variance, as
    ``tfhe_tpu``'s does, and each rank keeps its own slice before the gather.

    The batch must divide over dp*ks, n_extract and the table's rows over ks."""
    if mesh.coords is None:
        return None
    const, ca, cb = gates.GATE_TABLE[name]
    dp_size, ks_size = mesh.shape
    params = cloud.params
    if params.n_extract % ks_size or cloud.ks_table.shape[0] % ks_size:
        raise ValueError(f"n_extract {params.n_extract} and the key-switch table's "
                         f"{cloud.ks_table.shape[0]} rows must divide over ks = {ks_size}")
    cols_per = params.n_extract // ks_size
    rows_per = cloud.ks_table.shape[0] // ks_size
    xs, ys = _slice_ct(x, mesh.index, mesh.size), _slice_ct(y, mesh.index, mesh.size)
    a_ext, b_ext, cv = bs.bootstrap_woks(gates._affine2(xs, ys, const, ca, cb), gates.MU, cloud)
    row, i = mesh.groups["ks"], mesh.coords[1]
    a_all = all_gather_cat(a_ext, row, ks_size, mesh)
    b_all = all_gather_cat(b_ext, row, ks_size, mesh)
    cv_all = all_gather_cat(cv, row, ks_size, mesh)
    onehot = bs.ks_onehot(a_all[:, i * cols_per:(i + 1) * cols_per].contiguous(), params)
    sums = bs.int8_matmul(onehot, cloud.ks_table[i * rows_per:(i + 1) * rows_per])
    sums = all_reduce_sum(sums, row, mesh)
    out = bs.ks_finalize(sums, b_all, cv_all, params)
    bsz = xs.b.shape[0]
    mine = out[i * bsz:(i + 1) * bsz]
    return _gather_ct(mine, mesh.group, mesh.size, mesh)
