"""Sharding over ranks of ``torch.distributed`` (port of ``tfhe_tpu.parallel``):
data-parallel gates and circuits, the tensor-parallel key switch (``mesh``),
Cannon's algorithm over a grid of ranks (``cannon``) and the multi-rank dry
run (``dryrun``)."""
from .mesh import make_mesh, sharded_gate2, sharded_bootstrap_step
