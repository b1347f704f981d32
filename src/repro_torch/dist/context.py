"""Mesh context and logical axes (port of ``repro.dist.context``).

Models are written against two *logical* axes, "dp" (data parallel) and
"model" (tensor parallel), which map onto whatever physical mesh is
active: ("data", "model") single-pod, ("pod", "data", "model") multi-pod
("dp" then spans pod x data).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (one process per rank); the
rules read only ``mesh_shape(mesh)``, a dict of dim name -> size, so they
accept a plain mapping or any object with a ``shape`` dict, as the
reference's rules accept a duck-typed mesh.

``constrain`` has no counterpart: eager torch has no sharding constraint
for a compiler to propagate.  The sharded layers place their activations
explicitly instead (``collectives``), and the engine places params and
caches by the rules of ``sharding``.

Whether a model call's batch rows are this data rank's block of the
global batch (a decode step over the rank's slots, a train step over its
rows) or the whole batch (every data rank prefills every prompt) is
state of the call, not of its shapes: ``rows_over_dp`` marks the former,
and layers whose rows are coupled (the MoE's capacity) read it through
``rows_split``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

_STATE = threading.local()

# logical axis name -> physical mesh axes (in priority order; only axes
# present in the active mesh are used)
_LOGICAL = {
    "dp": ("pod", "data"),
    "model": ("model",),
    "dp+model": ("pod", "data", "model"),
}


def mesh_shape(mesh) -> Dict[str, int]:
    """Dim name -> size of a ``DeviceMesh``, of an object with a ``shape``
    mapping (the reference's duck-typed meshes), or of a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    shape = getattr(mesh, "shape", mesh)
    return {str(n): int(s) for n, s in dict(shape).items()}


def get_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh of this thread (None: no mesh)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def rows_split() -> bool:
    """True inside ``rows_over_dp``: the batch rows of this thread's model
    calls are this data rank's block of the global batch."""
    return getattr(_STATE, "rows", False)


@contextlib.contextmanager
def rows_over_dp(split: bool = True):
    """Mark (``split``) or unmark the batch rows of the model calls inside
    as this data rank's block of the global batch, in rank order over
    "dp"."""
    prev = getattr(_STATE, "rows", False)
    _STATE.rows = bool(split)
    try:
        yield
    finally:
        _STATE.rows = prev


def snapshot():
    """This thread's mesh context (the active mesh and ``rows_split``),
    for ``restore`` on another thread."""
    return get_mesh(), rows_split()


@contextlib.contextmanager
def restore(state):
    """Re-enter a ``snapshot`` (a backward's recompute, which the autograd
    engine may run on a thread of its own)."""
    mesh, split = state
    with use_mesh(mesh), rows_over_dp(split):
        yield


def physical_axes(mesh, logical: Optional[str]) -> Tuple[str, ...]:
    """Physical mesh axes backing a logical axis name (may be empty)."""
    if logical is None:
        return ()
    shape = mesh_shape(mesh)
    return tuple(a for a in _LOGICAL[logical] if a in shape)


def _axis_size(mesh, logical: Optional[str]) -> int:
    shape = mesh_shape(mesh)
    size = 1
    for a in physical_axes(mesh, logical):
        size *= shape[a]
    return size


def spec_entry(mesh, logical: Optional[str]):
    """PartitionSpec entry for one logical axis (None / name / tuple)."""
    axes = physical_axes(mesh, logical)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes
