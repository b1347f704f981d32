"""The collectives of the sharded serving path, over the process groups
of a ``DeviceMesh``.

Every collective on the served path is an all-gather, or a sum with at
most one non-zero term (the vocab-sharded embedding lookup), so sharded
tokens equal unsharded ones bit for bit: no partial products are summed.

The route of an all-gather is chosen by the group's backend, never by
catching a failure:

  * ``nccl``: ``all_gather_into_tensor`` (``all_gather_single`` where
    torch has it) into one flat buffer;
  * ``gloo`` on CPU tensors: the same call (gloo gathers CPU tensors);
  * ``gloo`` on CUDA tensors (ranks that share one card, where NCCL
    refuses two ranks on one device): gloo reduces CUDA tensors but
    does not gather them, so each rank writes its part at its own offset
    of a zero-filled buffer and the group sums the buffer's BYTES (a
    ``uint8`` view): one non-zero term per byte, so the sum is exact.
    The call is scoped ``c10d::all_gather_via_all_reduce`` so the
    contract rules read it as the all-gather it is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import op_trace

from . import context as dctx

_VIA_ALL_REDUCE = "c10d::all_gather_via_all_reduce"


def group(mesh, axis: str):
    """The process group of mesh dim ``axis`` ("data" or "model")."""
    return mesh.get_group(axis)


def coordinate(mesh, axis: str) -> int:
    """This rank's index along mesh dim ``axis`` (0 when the mesh has no
    such dim)."""
    if axis not in dctx.mesh_shape(mesh):
        return 0
    return int(mesh.get_local_rank(axis))


def axis_size(mesh, axis: str) -> int:
    return dctx.mesh_shape(mesh).get(axis, 1)


def _gather_flat(out: torch.Tensor, x: torch.Tensor, pg) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=pg)


def gather_into(out: torch.Tensor, x: torch.Tensor, pg) -> None:
    """Every rank's contiguous ``x`` into ``out`` ((parts * n, ...) or
    (parts, n, ...), rank order) over process group ``pg``, by the
    backend's route (see the module docstring)."""
    if x.is_cuda and dist.get_backend(pg) == "gloo":
        with op_trace.scope(_VIA_ALL_REDUCE):
            flat = out.view(-1)
            flat.zero_()
            n = x.numel()
            r = dist.get_rank(pg)
            flat[r * n:(r + 1) * n] = x.reshape(-1)
            dist.all_reduce(flat.view(torch.uint8), group=pg)
    else:
        _gather_flat(out.view((-1,) + tuple(x.shape[1:])), x, pg)


def all_gather(x: torch.Tensor, dim: int, axis: str = "model",
               mesh=None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order along
    mesh dim ``axis`` (the active mesh unless ``mesh`` is given)."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    parts = axis_size(mesh, axis)
    if parts == 1:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((parts * x0.shape[0],) + x0.shape[1:], dtype=x.dtype,
                      device=x.device)
    gather_into(out, x0, group(mesh, axis))
    return out.movedim(0, dim) if dim != 0 else out


def sum_one_nonzero(x: torch.Tensor, axis: str = "model",
                    mesh=None) -> torch.Tensor:
    """Sum ``x`` over mesh dim ``axis`` where at most one rank holds a
    non-zero value at each position (exact), in place."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(x, group=group(mesh, axis))
    return x


def shard_slice(size: int, parts: int, index: int) -> slice:
    """The ``index``-th of ``parts`` equal contiguous blocks of ``size``."""
    n = size // parts
    return slice(index * n, (index + 1) * n)


def model_shard(t: torch.Tensor) -> Optional[tuple]:
    """(dim, parts, index) of a tensor the engine placed as a shard along
    "model" (see ``sharding.place_model``), else None."""
    return getattr(t, "_model_shard", None)


def elementwise(y: torch.Tensor, t: torch.Tensor, op) -> torch.Tensor:
    """``op(y, t)`` for a replicated activation ``y`` (..., F) and a
    vector ``t`` of the F axis: when ``t`` is a model shard, the op runs
    on this rank's slice of ``y`` and the slices are all-gathered (exact:
    an elementwise op), else directly."""
    sh = model_shard(t)
    if sh is None:
        return op(y, t)
    _, parts, index = sh
    sl = shard_slice(y.shape[-1], parts, index)
    return all_gather(op(y[..., sl], t), dim=-1)
