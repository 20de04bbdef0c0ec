"""The active mesh, and the sharding hints of the JAX package.

Counterpart of `gsavatar/parallel/context.py` (`sharding_scope` :23,
`active_mesh` :34, `hint` :38). Inside `sharding_scope(mesh)` the
rasterizer finds the mesh through `active_mesh()` and, with more than one
rank on its `model` axis, composites each rank's tile range
(`ops/rasterizer/api.py`)."""
from __future__ import annotations

import contextlib
from typing import Optional

from .mesh import Mesh

_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def sharding_scope(mesh: Mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def active_mesh() -> Optional[Mesh]:
    return _MESH


def hint(x, *axes):
    """Returns `x`. In the JAX package a hint asks XLA's SPMD partitioner
    to lay `x`'s leading dims over the named mesh axes, and XLA places the
    collectives between two layouts. Eager PyTorch has no partitioner: the
    port's collectives are explicit and do what the hints ask for, the
    compositor's tile split over `model`
    (`composite.make_composite_pairs_sharded`) and the gradient sum over
    `data` (`shard.make_sharded_train_step`). The one hint of the pairs
    route with no counterpart, the arena rows over `model` in the geometry
    stages (`gsavatar/parallel/shard.py:122`), leaves them replicated; the
    other hints (`gsavatar/ops/rasterizer/api.py:106`, `composite.py:
    99-104`) belong to the XLA dense route, which the port does not
    have."""
    return x
