"""Op traces of one eager step: the port's counterpart of the query half of
``repro.dist.hlo_analysis`` (``collective_instructions``,
``gather_instructions``, ``copy_instructions``, ``convert_instructions``,
``host_transfer_instructions``, ``donation_aliases``).

The reference lowers its decode jit and reads the compiled HLO text.
PyTorch runs eagerly, so the port runs the step once under
``torch.profiler`` (``capture``) and reads the ops it ran: each record is
an op name, its input shapes and dtypes and its input bytes; on the card
the trace also holds the device's memcpys and the runtime's
synchronisations.  The query functions below interpret those records,
one function per reference query, so the rules (``op_rules.py``) and the
tests share one reader.

Scopes.  Code on the step's path marks itself with ``scope(name)`` — a
``torch.profiler.record_function`` while a profiler records, a no-op
otherwise:

  * ``K1`` (the dequant GEMM's wrapper, ``kernels/dequant_matmul.py``) and
    ``DEQUANTIZE`` (a plan's weight-space dequantize: the MoE experts, MLA's
    absorbed weights) are FOLDED: the scope stays one record and the torch
    ops it ran (the plain K1's x gather on the CPU, the wrapper's workspace
    allocations on the card) are dropped, as the reference's HLO shows one
    custom call for the Pallas kernel.  ``K1`` carries its ``x_mode`` as a
    suffix (``repro_torch::dequant_matmul[gathered]``);
  * ``QMATMUL`` (one prepared matmul, ``kernels/ops.prepared_qmatmul``)
    carries its plan's count of permuted groups
    (``repro_torch::prepared_qmatmul[permuted=2]``): the call site GA1
    reads;
  * ``TO_HOST`` and ``TO_DEVICE`` are the engine's two counted transfer
    helpers: the one sanctioned device-to-host transfer of a step (the
    sampled tokens, with the guard counts) and its uploads (tokens, a dirty
    page table, a fault vector).

The CPU profiler does not see every host transfer (``tolist()`` records
no op, ``cpu()`` of a CPU tensor no copy), so on the CPU the step's
transfers are its helper scopes and any ``_local_scalar_dense`` (an
``item()``, ``int()``, ``float()`` or ``bool()`` of a tensor) or
``nonzero``; on the card the device's ``Memcpy DtoH``/``HtoD`` and the
runtime's ``*Synchronize`` calls are counted against the helpers.

The recorder.  ``record`` runs a function under a
``TorchDispatchMode`` and returns an ``OpTrace`` of every aten op it
dispatched, with result shapes (``out_shapes``) and whether the op
returns a view of its input (``alias``): on meta tensors too, where the
profiler sees no device.  Code that stands in for work the dispatcher
does not see declares it with ``note`` (a no-op unless a recorder is
active): the dry run's stand-in collectives (``dist.standin``) and K1 on
meta tensors, one record each with its FLOPs.  ``dist.op_analysis``
reads such a trace for the reference's ``analyze_hlo`` keys.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

PREFIX = "repro_torch::"
STEP = PREFIX + "step"
K1 = PREFIX + "dequant_matmul"
DEQUANTIZE = PREFIX + "dequantize"
QMATMUL = PREFIX + "prepared_qmatmul"
TO_HOST = PREFIX + "to_host"
TO_DEVICE = PREFIX + "to_device"
_FOLDED = (K1, DEQUANTIZE)

# the profiler's dtype names -> the reference's HLO element types
_DTYPES = {"float": ("f32", 4), "double": ("f64", 8), "c10::Half": ("f16", 2),
           "c10::BFloat16": ("bf16", 2), "signed char": ("s8", 1),
           "unsigned char": ("u8", 1), "short int": ("s16", 2),
           "int": ("s32", 4), "long int": ("s64", 8), "bool": ("pred", 1)}
_GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather",
               "aten::take", "aten::take_along_dim", "aten::embedding")
_COPY_PARENTS = ("aten::clone", "aten::_to_copy", "aten::contiguous")
# host syncs visible on the CPU: a scalar read of a tensor, a data-
# dependent output shape
_SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero")
# the profiler's names of c10d collectives -> the reference's HLO kinds
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                ("broadcast", "broadcast"))


def scope(name: str, suffix=""):
    """A profiler scope ``name[suffix]`` while a profiler records, else a
    no-op context (the hot path pays one flag read).  ``suffix`` may be a
    callable, evaluated only while recording."""
    if torch.autograd._profiler_enabled():
        if callable(suffix):
            suffix = suffix()
        return torch.profiler.record_function(
            f"{name}[{suffix}]" if suffix else name)
    return contextlib.nullcontext()


def profiled(name: str):
    """Decorator: run the function in ``scope(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with scope(name):
                return fn(*args, **kw)
        return wrapped
    return deco


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a captured step.  ``kind``: "op" (an aten op or a scope),
    "runtime" (a CUDA runtime call), "device" (a kernel or memcpy on the
    card).  ``path``: the names of the enclosing records, outermost first;
    ``site``: the index of the innermost enclosing ``QMATMUL`` record, or
    -1.  ``nbytes``: the bytes of the op's tensor inputs (a memcpy's own
    size on the card)."""
    name: str
    kind: str = "op"
    shapes: Tuple[Tuple[int, ...], ...] = ()
    dtypes: Tuple[str, ...] = ()
    nbytes: int = 0
    path: Tuple[str, ...] = ()
    site: int = -1
    out_shapes: Tuple[Tuple[int, ...], ...] = ()   # ``record`` only
    out_dtypes: Tuple[str, ...] = ()
    alias: bool = False    # a view of an input: no bytes move
    flops: float = 0.0     # declared by ``note`` (a folded kernel)


@dataclasses.dataclass
class OpTrace:
    """The records of one captured step.  ``leaves``: for each cache leaf
    the step received, whether it still holds the same storage afterwards
    (updated in place) — None when the caller did not record them."""
    records: List[OpRecord]
    leaves: Optional[Dict[str, bool]] = None


def _bytes(shape: Sequence[int], dtype: str) -> int:
    """Bytes of a tensor operand (0 for a scalar or list operand)."""
    n = 1
    for d in shape:
        if not isinstance(d, int):
            return 0
        n *= d
    return n * _DTYPES.get(dtype, ("", 0))[1]


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def from_events(events) -> OpTrace:
    """Records of the ``STEP`` window of a profiler's kineto events:
    host-side events nest by time (the step runs on one thread), the
    host-side children of a folded scope are dropped (runtime calls are
    kept), and every device event is kept."""
    host, dev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(e)
        else:
            dev.append(e)
    window = [e for e in host if e.name() == STEP]
    if not window:
        raise ValueError("no step scope in the profile")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    host = sorted((e for e in host if w0 <= e.start_ns() and e.end_ns() <= w1
                   and e.name() != STEP),
                  key=lambda e: (e.start_ns(), -e.end_ns()))
    records: List[OpRecord] = []
    stack: List[Tuple[Any, int]] = []       # (event, record index or -1)
    for e in host:
        stack = [x for x in stack if x[0].end_ns() > e.start_ns()]
        runtime = _is_runtime(e.name())
        if not runtime and any(
                r >= 0 and records[r].name.split("[")[0] in _FOLDED
                for _, r in stack):
            stack.append((e, -1))
            continue
        shapes = tuple(tuple(s) for s in e.shapes())
        dtypes = tuple(e.dtypes())
        site = next((r for _, r in reversed(stack) if r >= 0
                     and records[r].name.startswith(QMATMUL)), -1)
        records.append(OpRecord(
            e.name(), "runtime" if runtime else "op", shapes,
            dtypes, sum(_bytes(s, d) for s, d in zip(shapes, dtypes)),
            tuple(records[r].name for _, r in stack if r >= 0), site))
        if not runtime:
            # runtime calls are leaves: CUPTI stamps them on its own
            # clock, so one may overhang its op and swallow the next
            stack.append((e, len(records) - 1))
    # every device event of the profile is the step's: ``capture`` syncs
    # the card before it starts recording and issues nothing else (device
    # timestamps are not compared with the host's: their clocks may skew)
    for e in sorted(dev, key=lambda e: e.start_ns()):
        n = getattr(e, "nbytes", 0)
        records.append(OpRecord(e.name(), "device",
                                nbytes=int((n() if callable(n) else n)
                                           or 0)))
    return OpTrace(records)


def capture(fn: Callable[[], Any], device="cpu"):
    """Run ``fn`` once under ``torch.profiler`` (shapes recorded; the card's
    activity too when ``device`` is CUDA) and return (its result, the
    ``OpTrace`` of the call)."""
    device = torch.device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        with torch.profiler.record_function(STEP):
            out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, from_events(prof.profiler.kineto_results.events())


# torch dtypes -> the profiler's names (the keys of ``_DTYPES``)
_TORCH_DTYPES = {torch.float32: "float", torch.float64: "double",
                 torch.float16: "c10::Half", torch.bfloat16: "c10::BFloat16",
                 torch.int8: "signed char", torch.uint8: "unsigned char",
                 torch.int16: "short int", torch.int32: "int",
                 torch.int64: "long int", torch.bool: "bool"}

# the active recorder: a module global, not a thread-local, since the
# autograd engine may run a backward (and its collectives) on a thread of
# its own; the recorder is the dry run's, which records one step at a time
_REC = types.SimpleNamespace(rec=None)


def _shapes(tensors):
    return (tuple(tuple(t.shape) for t in tensors),
            tuple(_TORCH_DTYPES.get(t.dtype, str(t.dtype)) for t in tensors))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def make_record(name: str, inputs, outputs, flops: float = 0.0,
                alias: bool = False) -> OpRecord:
    """An ``OpRecord`` of ``name`` over the tensors of ``inputs`` and
    ``outputs`` (any nesting; ``None`` and non-tensors skipped)."""
    ins, outs = _tensors(inputs), _tensors(outputs)
    shapes, dtypes = _shapes(ins)
    out_shapes, out_dtypes = _shapes(outs)
    return OpRecord(name, "op", shapes, dtypes,
                    sum(_bytes(s, d) for s, d in zip(shapes, dtypes)),
                    out_shapes=out_shapes, out_dtypes=out_dtypes,
                    alias=alias, flops=float(flops))


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self.quiet = 0

    def __torch_dispatch__(self, func, arg_types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.quiet:
            self.records.append(make_record(
                func._schema.name, (args, kwargs), out,
                alias=bool(getattr(func, "is_view", False))))
        return out


def record(fn: Callable[[], Any]):
    """Run ``fn`` once under the op recorder and return (its result, the
    ``OpTrace`` of every aten op it dispatched and every ``note``)."""
    rec = _Recorder()
    prev, _REC.rec = _REC.rec, rec
    try:
        with rec:
            out = fn()
    finally:
        _REC.rec = prev
    return out, OpTrace(rec.records)


def note(name: str, inputs, outputs, flops: float = 0.0) -> None:
    """Record one op the dispatcher does not see (a stand-in collective, a
    folded kernel on meta tensors) when a recorder is active."""
    rec = _REC.rec
    if rec is not None:
        rec.records.append(make_record(name, inputs, outputs, flops))


@contextlib.contextmanager
def quiet():
    """Record none of the ops dispatched inside (the implementation of a
    ``note``d op)."""
    rec = _REC.rec
    if rec is None:
        yield
        return
    rec.quiet += 1
    try:
        yield
    finally:
        rec.quiet -= 1


def _ops(trace: OpTrace) -> List[OpRecord]:
    return [r for r in trace.records if r.kind == "op"]


def collective_instructions(trace: OpTrace) -> List[Tuple[str, int]]:
    """Every c10d collective of the step as ``[(kind, bytes), ...]`` in the
    reference's kinds ("all-gather", "all-reduce", ...), each listed once
    (the outermost record; its ``nccl:``/``gloo:`` children are not
    counted again).  ``bytes`` is the largest tensor operand (the output
    of ``all_gather_into_tensor``) of the record or of the records nested
    in it.  A collective over a tensor list (``c10d::allreduce_``) records
    no shapes itself: its backend's record does (``gloo:all_reduce``),
    which gloo stamps on a thread of its own, so it need not nest; the
    first such record of the same kind before the next collective gives
    the bytes then."""
    ops = _ops(trace)
    out = []
    for i, r in enumerate(ops):
        low = r.name.lower()
        if not (low.startswith("c10d::") or low.startswith("nccl:")):
            continue
        if any(p.lower().startswith(("c10d::", "nccl:")) for p in r.path):
            continue
        kind = next((k for key, k in _COLLECTIVES if key in low), None)
        if kind is not None:
            depth = len(r.path)
            inner = [r]
            for c in ops[i + 1:]:
                if len(c.path) <= depth or c.path[depth] != r.name:
                    break
                inner.append(c)
            big = max((_bytes(s, d) for x in inner
                       for s, d in zip(x.shapes, x.dtypes)), default=0)
            if big == 0:
                for c in ops[i + 1:]:
                    low_c = c.name.lower()
                    if low_c.startswith("c10d::"):
                        break
                    if low_c.startswith(("gloo:", "nccl:")) and kind == next(
                            (k for key, k in _COLLECTIVES if key in low_c),
                            None):
                        big = max((_bytes(s, d) for s, d in
                                   zip(c.shapes, c.dtypes)), default=0)
                        break
            out.append((kind, big))
    return out


def gather_instructions(trace: OpTrace) -> List[Tuple[str, int]]:
    """Every torch gather of the step (``index``, ``index_select``,
    ``gather``, ``take``, ``embedding``; the outermost of a nest, each once)
    as ``[(op, input_bytes), ...]``.  K1's in-kernel gather is not a torch
    op: its scope is folded, on the CPU (the plain version's take) and on
    the card alike."""
    return [(r.name, r.nbytes) for r in _ops(trace)
            if r.name in _GATHER_OPS
            and not any(p in _GATHER_OPS for p in r.path)]


def copy_instructions(trace: OpTrace) -> List[Tuple[str, int]]:
    """Every tensor copy of the step as ``[(op, result_bytes), ...]``: each
    ``aten::copy_`` (the leaf every ``clone``, ``to`` and ``contiguous``
    ends in) named by its nearest copying parent, sized by its
    destination."""
    out = []
    for r in _ops(trace):
        if r.name != "aten::copy_" or not r.shapes:
            continue
        name = next((p for p in reversed(r.path) if p in _COPY_PARENTS),
                    r.name)
        out.append((name, _bytes(r.shapes[0], r.dtypes[0])))
    return out


def convert_instructions(trace: OpTrace) -> List[Tuple[str, str, int]]:
    """Every dtype-changing copy as ``[(src, dst, elems), ...]`` in HLO
    element types ("s8", "f32", ...), as the reference's convert list."""
    out = []
    for r in _ops(trace):
        if r.name != "aten::copy_" or len(r.dtypes) < 2:
            continue
        dst, src = r.dtypes[0], r.dtypes[1]
        if dst == src or dst not in _DTYPES or src not in _DTYPES:
            continue
        elems = _bytes(r.shapes[0], dst) // _DTYPES[dst][1]
        out.append((_DTYPES[src][0], _DTYPES[dst][0], elems))
    return out


def transfer_counts(trace: OpTrace) -> Dict[str, int]:
    """The step's host/device traffic: helper scopes (``to_host``,
    ``to_device``), the device's memcpys (``dtoh``, ``htod``), runtime
    synchronisations (``sync``) and CPU-visible syncing ops (``scalar``)."""
    c = collections.Counter()
    for r in trace.records:
        if r.kind == "op":
            if r.name == TO_HOST:
                c["to_host"] += 1
            elif r.name == TO_DEVICE:
                c["to_device"] += 1
            elif r.name in _SYNC_OPS:
                c["scalar"] += 1
        elif r.kind == "runtime" and "Synchronize" in r.name:
            c["sync"] += 1
        elif r.kind == "device" and "Memcpy DtoH" in r.name:
            c["dtoh"] += 1
        elif r.kind == "device" and "Memcpy HtoD" in r.name:
            c["htod"] += 1
    return {k: c[k] for k in ("to_host", "to_device", "dtoh", "htod", "sync",
                              "scalar")}


def host_transfer_instructions(trace: OpTrace) -> List[Tuple[str, int]]:
    """Every host transfer of the step that the two helpers do not account
    for, as ``[(op, bytes), ...]``: a syncing op outside ``to_host`` (a
    scalar read, ``nonzero``), and on the card each memcpy or runtime
    synchronisation past the helpers' budget (one memcpy in its direction
    and one synchronisation per helper call)."""
    out = [(r.name, r.nbytes) for r in _ops(trace)
           if r.name in _SYNC_OPS and TO_HOST not in r.path]
    c = transfer_counts(trace)
    budget = {"Memcpy DtoH": c["to_host"], "Memcpy HtoD": c["to_device"],
              "Synchronize": c["to_host"] + c["to_device"]}
    for r in trace.records:
        if r.kind == "op":
            continue
        key = next((k for k in budget if k in r.name), None)
        if key is None or (key == "Synchronize") != (r.kind == "runtime"):
            continue
        if budget[key] > 0:
            budget[key] -= 1
        else:
            out.append((r.name, r.nbytes))
    return out


def kernel_sites(trace: OpTrace) -> List[Tuple[int, List[str]]]:
    """Each prepared matmul of the step as ``(permuted groups of its plan,
    [x_mode of each K1 launch it made])``."""
    sites: Dict[int, Tuple[int, List[str]]] = {}
    for i, r in enumerate(trace.records):
        if r.kind != "op":
            continue
        if r.name.startswith(QMATMUL + "["):
            sites[i] = (int(r.name.split("permuted=")[1].rstrip("]")), [])
        elif r.name.startswith(K1 + "[") and r.site in sites:
            sites[r.site][1].append(r.name[len(K1) + 1:-1])
    return list(sites.values())


def k1_modes(trace: OpTrace) -> Dict[str, int]:
    """K1 launches of the step by ``x_mode`` (host records: on the card
    each scope also has a device-side annotation of the same name)."""
    return dict(collections.Counter(
        r.name[len(K1) + 1:-1] for r in _ops(trace)
        if r.name.startswith(K1 + "[")))


def donation_aliases(trace: OpTrace) -> List[str]:
    """The cache leaves the step updated in place (same storage after the
    step) — the port's analogue of the reference's input/output aliases."""
    return sorted(k for k, same in (trace.leaves or {}).items() if same)


def moved_leaves(trace: OpTrace) -> List[str]:
    """The cache leaves the step replaced with new tensors."""
    return sorted(k for k, same in (trace.leaves or {}).items() if not same)
