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

Training differentiates through the same collectives (``autograd.Function``
forms, taken only when a gradient is needed, so serving runs the
forward-only code and its op trace is unchanged):

  * ``all_gather``'s backward is this rank's slice of the gradient: the
    gathered activation is replicated downstream, so every model rank
    holds the same upstream gradient and nothing is reduced.  Where the
    downstream is NOT replicated (the MoE gathers its input rows over
    "dp", routes them all and keeps its own: each data rank's gradient
    is its own rows' part), ``all_gather(..., replicated_grad=False)``
    sums the gradient over the axis first (a reduce-scatter);
  * ``all_sum``'s backward is ``all_sum`` of the gradient (a sum's
    adjoint);
  * ``replicated`` is the identity on the replicated input of a sharded
    op, and its backward sums the gradient over the axis: each rank's
    input gradient is a partial (its own output columns' ``dY_r W_r^T``,
    or its own slice of an elementwise op), and without the sum every
    replicated weight upstream would get a different gradient on each
    model rank;
  * ``sum_one_nonzero``'s backward is the identity.

A ``dist.standin.StandInMesh`` (the dry run's stand-in of a production
mesh) routes every collective to ``standin``: meta tensors of the right
shape, each collective recorded with its kind and bytes.  Real tensors
never meet a stand-in mesh, nor meta tensors a real one: both raise.

``exchange`` moves rows between the ranks of "dp" (a paged pool's pages
to the ranks whose slots name them): an all-to-all of bytes, so exact.
One route serves every backend: ``all_to_all_single`` with uneven
splits, which nccl runs natively and gloo runs on CPU tensors and, for
ranks sharing one card, on CUDA tensors too (``chip_smoke.py``'s phase
14f exchanges pages so on an H100 with torch 2.11, bit for bit).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import op_trace

from . import context as dctx
from . import standin

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
    """The size of mesh dim ``axis`` (1 without a mesh or such a dim)."""
    return 1 if mesh is None else dctx.mesh_shape(mesh).get(axis, 1)


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


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _real(x: torch.Tensor, mesh) -> bool:
    """True for a process-group mesh; False for a stand-in mesh (meta
    tensors only).  Raises where a real tensor meets a stand-in mesh or a
    meta tensor a real one."""
    if isinstance(mesh, standin.StandInMesh):
        standin.check(x)
        return False
    if x.is_meta:
        raise TypeError("a meta tensor on a process-group mesh: the dry "
                        "run places its model on a stand-in mesh")
    return True


def all_gather(x: torch.Tensor, dim: int, axis: str = "model",
               mesh=None, replicated_grad: bool = True) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order along
    mesh dim ``axis`` (the active mesh unless ``mesh`` is given).
    ``replicated_grad=False``: the ranks' downstream gradients differ,
    and the backward sums them over ``axis`` before taking this rank's
    block."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) == 1:
        return x
    if _needs_grad(x):
        return _AllGather.apply(x, dim, axis, mesh, replicated_grad)
    return _all_gather(x, dim, axis, mesh)


def _all_gather(x, dim, axis, mesh):
    parts = axis_size(mesh, axis)
    if not _real(x, mesh):
        return standin.all_gather(x, dim, parts)
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((parts * x0.shape[0],) + x0.shape[1:], dtype=x.dtype,
                      device=x.device)
    gather_into(out, x0, group(mesh, axis))
    return out.movedim(0, dim) if dim != 0 else out


def all_reduce_(x: torch.Tensor, axis: str = "model", mesh=None
                ) -> torch.Tensor:
    """Sum ``x`` over mesh dim ``axis`` in place (forward only); returns
    ``x``."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) > 1:
        if _real(x, mesh):
            dist.all_reduce(x, group=group(mesh, axis))
        else:
            standin.all_reduce(x, axis_size(mesh, axis))
    return x


def all_sum(x: torch.Tensor, axis: str = "model", mesh=None
            ) -> torch.Tensor:
    """The sum of ``x`` over mesh dim ``axis`` (a new tensor when the axis
    has several ranks); when a gradient is needed, its backward sums the
    gradient over ``axis``."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) == 1:
        return x
    if _needs_grad(x):
        return _AllSum.apply(x, axis, mesh)
    return all_reduce_(x.clone(), axis, mesh)


def sum_one_nonzero(x: torch.Tensor, axis: str = "model",
                    mesh=None) -> torch.Tensor:
    """Sum ``x`` over mesh dim ``axis`` where at most one rank holds a
    non-zero value at each position (exact): in place, or into a new
    tensor when a gradient is needed."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) == 1:
        return x
    if _needs_grad(x):
        return _SumOneNonzero.apply(x, axis, mesh)
    return all_reduce_(x, axis, mesh)


def replicated(x: torch.Tensor, axis: str = "model", mesh=None
               ) -> torch.Tensor:
    """``x``, the replicated input of an op sharded over ``axis``; when a
    gradient is needed, an identity whose backward sums the gradient over
    ``axis`` (each rank's is its share's partial)."""
    if not _needs_grad(x):
        return x
    mesh = dctx.get_mesh() if mesh is None else mesh
    if axis_size(mesh, axis) == 1:
        return x
    return _SumGrad.apply(x, axis, mesh)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, replicated_grad):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        ctx.replicated_grad = replicated_grad
        return _all_gather(x, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        parts = axis_size(ctx.mesh, ctx.axis)
        n = g.shape[ctx.dim] // parts
        index = coordinate(ctx.mesh, ctx.axis)
        if not ctx.replicated_grad:
            g = all_reduce_(g.contiguous().clone(), ctx.axis, ctx.mesh)
        return g.narrow(ctx.dim, index * n, n), None, None, None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return all_reduce_(x.clone(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis, ctx.mesh), \
            None, None


class _SumOneNonzero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce_(x.clone(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis, ctx.mesh), \
            None, None


def gather_dp(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every "dp" rank's rows of ``t`` (dim 0) in "dp" order: gathered over
    "data", then "pod" ("dp" is pod x data, row-major, as
    ``sharding.entry_block`` reads it)."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    if mesh is None:
        return t
    for a in reversed(dctx.physical_axes(mesh, "dp")):
        t = all_gather(t, dim=0, axis=a, mesh=mesh)
    return t


def dp_index(mesh) -> int:
    """This rank's index along "dp" (pod x data, row-major)."""
    idx = 0
    for a in dctx.physical_axes(mesh, "dp"):
        idx = idx * axis_size(mesh, a) + coordinate(mesh, a)
    return idx


def dp_group(mesh):
    """The process group of this rank's "dp" ranks, in "dp" order (pod
    x data, row-major), or None when "dp" has one rank.  Where both pod
    and data have several ranks, every rank makes the group of every
    "dp" row once (``new_group`` is collective), kept on the mesh."""
    axes = [a for a in dctx.physical_axes(mesh, "dp")
            if axis_size(mesh, a) > 1]
    if len(axes) <= 1:
        return group(mesh, axes[0]) if axes else None
    groups = getattr(mesh, "_dp_groups", None)
    if groups is None:
        names = list(mesh.mesh_dim_names)
        order = ([names.index(a) for a in names if a not in axes]
                 + [names.index(a) for a in axes])
        width = axis_size(mesh, axes[0]) * axis_size(mesh, axes[1])
        groups = {}
        for row in mesh.mesh.permute(order).reshape(-1, width).tolist():
            pg = dist.new_group(row)
            if dist.get_rank() in row:
                groups["mine"] = pg
        mesh._dp_groups = groups
    return groups["mine"]


def exchange(x: torch.Tensor, counts, mesh=None) -> torch.Tensor:
    """Rows between the ranks of "dp": ``counts[s][d]`` rows go from "dp"
    rank s to rank d (``counts[r][r]`` is 0); ``x`` holds this rank's
    outgoing rows grouped by destination in rank order.  Returns the
    incoming rows grouped by source in rank order.  Bytes only, so every
    row arrives bit for bit (see the module docstring); a stand-in mesh
    records the all-to-all."""
    mesh = dctx.get_mesh() if mesh is None else mesh
    n = len(counts)
    me = dp_index(mesh)
    recv = [int(counts[s][me]) for s in range(n)]
    if not _real(x, mesh):
        return standin.all_to_all(x, sum(recv), n)
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, recv, [int(c) for c in counts[me]],
                           group=dp_group(mesh))
    return out


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
    return all_gather(op(replicated(y)[..., sl], t), dim=-1)


# ---------------------------------------------------------------------------
# One rank's objects to every rank (the launcher's single controller)
# ---------------------------------------------------------------------------

def broadcast_(t: torch.Tensor, src: int = 0, pg=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` into every rank's ``t`` (same shape and dtype),
    in place, by the group's backend: ``dist.broadcast``, except gloo on
    a CUDA tensor, where rank ``src`` writes its bytes into a zero-filled
    buffer and the group sums it as bytes (one non-zero term a byte:
    exact), the route ``gather_into`` takes."""
    if t.numel() == 0:
        return t
    if t.is_cuda and dist.get_backend(pg) == "gloo":
        if dist.get_rank(pg) != src:
            t.zero_()
        flat = t.view(-1).view(torch.uint8)
        dist.all_reduce(flat, group=pg)
    else:
        dist.broadcast(t, src=src, group=pg)
    return t


def broadcast_object(obj, device, src: int = 0, pg=None):
    """Rank ``src``'s ``obj`` (any picklable tree: a model, quantized
    tensors) on every rank.  The structure travels pickled
    (``broadcast_object_list``), with each tensor replaced by its shape
    and dtype; the tensors then travel one by one (``broadcast_``) into
    tensors each rank allocates on ``device``.  Other ranks pass any
    ``obj`` (ignored).  Returns rank ``src``'s object, its tensors on
    ``device`` (the same objects on rank ``src``)."""
    import io
    import pickle

    rank = dist.get_rank(pg)
    tensors = []
    payload = [None]
    if rank == src:
        memo = {}

        class _Out(pickle.Pickler):
            def persistent_id(self, x):
                if not isinstance(x, torch.Tensor):
                    return None
                if id(x) not in memo:
                    memo[id(x)] = len(tensors)
                    tensors.append(x)
                return ("tensor", memo[id(x)], tuple(x.shape), x.dtype)

        buf = io.BytesIO()
        _Out(buf).dump(obj)
        payload = [buf.getvalue()]
    dist.broadcast_object_list(payload, src=src, group=pg)
    if rank != src:
        made = {}

        class _In(pickle.Unpickler):
            def persistent_load(self, pid):
                _, i, shape, dtype = pid
                if i not in made:
                    made[i] = torch.empty(shape, dtype=dtype, device=device)
                return made[i]

        obj = _In(io.BytesIO(payload[0])).load()
        tensors = [made[i] for i in range(len(made))]
    for t in tensors:
        broadcast_(t if t.is_contiguous() else t.contiguous(), src, pg)
    return obj
