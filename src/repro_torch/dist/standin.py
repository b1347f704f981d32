"""The dry run's stand-in of a production mesh: rank 0's view of a (16,
16) or (2, 16, 16) mesh, without a process group.

The reference lowers a dry-run cell on 512 forced host devices.  The port
builds the model on the ``meta`` device, takes rank 0's blocks by the
sharding rules on a ``StandInMesh`` and runs the cell's entry point once:
every collective the sharded layers call (``dist.collectives``) returns a
meta tensor of the shape the real one would, and is recorded with its
kind and bytes (``analysis.op_trace.note``, named with its group's
size), as a real rank's op trace records it.  Nothing else changes on
the path, so the collectives of a dry run are those of a real rank of
that mesh.

This is the dry run's explicit mode: a stand-in mesh takes meta tensors
only (``check`` raises on a real one), and ``collectives`` refuses a
meta tensor on a real mesh.  Serving and training never build one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.analysis import op_trace

# the names a real rank's op trace gives these collectives (a gloo or
# nccl all-gather is ``c10d::_allgather_base_``, a sum ``c10d::allreduce_``)
ALL_GATHER = "c10d::_allgather_base_"
ALL_REDUCE = "c10d::allreduce_"
ALL_TO_ALL = "c10d::alltoall_base_"


class StandInMesh:
    """Rank ``coords`` (default: rank 0) of a mesh of ``shape`` (dim name ->
    size, in order).  Duck-types the parts of a ``DeviceMesh`` the sharding
    rules and the collectives read; it has no process groups."""

    def __init__(self, shape: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(int(v) for v in shape.values())
        self._coords = dict(coords or {a: 0 for a in shape})

    def get_local_rank(self, axis: str) -> int:
        return self._coords[axis]

    def get_group(self, axis: str):
        raise TypeError("a stand-in mesh has no process groups: its "
                        "collectives are recorded, not run")

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return f"StandInMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def check(x: torch.Tensor) -> None:
    if not x.is_meta:
        raise TypeError(f"a {x.device} tensor on a stand-in mesh: the dry "
                        f"run's mesh takes meta tensors only")


def all_gather(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """The all-gather of ``parts`` blocks like ``x`` along ``dim``."""
    shape = list(x.shape)
    shape[dim] *= parts
    with op_trace.quiet():
        out = torch.empty(shape, dtype=x.dtype, device="meta")
    op_trace.note(f"{ALL_GATHER}[{parts}]", [out], [out])
    return out


def all_reduce(x: torch.Tensor, parts: int) -> torch.Tensor:
    """The in-place sum of ``x`` over ``parts`` ranks (returned as it
    is)."""
    op_trace.note(f"{ALL_REDUCE}[{parts}]", [x], [x])
    return x


def all_to_all(x: torch.Tensor, rows: int, parts: int) -> torch.Tensor:
    """The ``rows`` rows like ``x``'s that an all-to-all over ``parts``
    ranks brings this rank."""
    with op_trace.quiet():
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device="meta")
    # a real rank's record holds both buffers (``alltoall_base_``'s
    # operands): its bytes are the larger
    op_trace.note(f"{ALL_TO_ALL}[{parts}]", [out, x], [out])
    return out
