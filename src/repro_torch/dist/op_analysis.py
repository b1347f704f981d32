"""Cost accounting over a recorded op stream: the counterpart of
``repro.dist.hlo_analysis.analyze_hlo``.

The reference walks the compiled HLO of a step.  The port runs the step
once under the op recorder (``analysis.op_trace.record``: every aten op
with its operand and result shapes, on meta tensors in the dry run) and
reads the stream with the reference's conventions:

  * ``flops`` counts matmul-class ops only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``convolution``...): 2 * result elements * the
    contraction length;
  * ``elementwise_flops`` charges each arithmetic elementwise op its
    result elements times the reference's weight (``hlo_analysis.py``
    ``_ELEMWISE_COST``): 1 for add/mul-class ops, 4 for divides and
    roots, 8 for transcendentals, mapped onto aten names; an aten kernel
    that XLA would lower to several such ops (``silu``, ``_softmax``
    and their backwards) is charged the sum of its parts.  Data movement
    and reductions are not arithmetic here, as there;
  * ``hbm_bytes`` is a result-bytes proxy per op; views and allocations
    are free;
  * collectives are keyed by the reference's kind names
    (``coll_all-gather``, ``coll_all-reduce``, ...; read as
    ``op_trace.collective_instructions`` reads them) and summed into
    ``collective_bytes``.

K1 is one record (``kernels.dequant_matmul`` on meta tensors notes it):
its declared 2 M N K FLOPs, and the bytes of its plan's planes,
codebooks, outlier tables, x and result; its plain version's dequantized
weight is never charged.  The hot path pays nothing for this: the meta
route is taken only for meta tensors, after the CUDA test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.analysis import op_trace

_MATMULS = {"aten::mm": 0, "aten::bmm": 0, "aten::addmm": 1,
            "aten::baddbmm": 1, "aten::addbmm": 1, "aten::_scaled_mm": 0}

_ELEMWISE_COST: Dict[str, float] = {}
for _op in ("add", "sub", "rsub", "mul", "neg", "abs", "maximum",
            "minimum", "where", "eq", "ne", "lt", "le", "gt", "ge",
            "logical_and", "logical_or", "logical_xor", "logical_not",
            "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
            "clamp", "clamp_min", "clamp_max", "floor", "ceil", "round",
            "sign", "bitwise_left_shift", "bitwise_right_shift",
            "__lshift__", "__rshift__", "relu", "masked_fill",
            "threshold_backward"):
    _ELEMWISE_COST[_op] = 1.0
for _op in ("div", "remainder", "fmod", "sqrt", "rsqrt", "reciprocal"):
    _ELEMWISE_COST[_op] = 4.0
for _op in ("exp", "expm1", "exp2", "log", "log1p", "log2", "tanh",
            "sigmoid", "sin", "cos", "tan", "atan2", "pow", "erf"):
    _ELEMWISE_COST[_op] = 8.0
# aten kernels XLA lowers to several elementwise ops: the sum of their
# parts (silu = x * logistic(x); softmax = exp(x - max) / sum; ...)
_ELEMWISE_COST.update({
    "silu": 9.0, "silu_backward": 13.0, "gelu": 15.0,
    "gelu_backward": 20.0, "_softmax": 13.0,
    "_softmax_backward_data": 3.0, "_log_softmax": 10.0,
    "_log_softmax_backward_data": 10.0})

# bookkeeping: no bytes move (views are marked by the recorder)
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::lift_fresh", "aten::detach", "aten::alias",
         "aten::_unsafe_view", "aten::_local_scalar_dense"}


def _elems(shape) -> int:
    return math.prod(shape) if shape else 1


def _base(name: str) -> str:
    """``aten::add_`` -> ``add`` (the in-place form costs the same)."""
    base = name.split("::", 1)[-1].split("[", 1)[0]
    return base[:-1] if base.endswith("_") and not base.startswith("_") \
        else base


def _matmul_flops(r: op_trace.OpRecord) -> float:
    lhs = _MATMULS.get(r.name)
    if lhs is not None and r.out_shapes and len(r.shapes) > lhs:
        return 2.0 * _elems(r.out_shapes[0]) * r.shapes[lhs][-1]
    if r.name == "aten::convolution" and r.out_shapes and len(r.shapes) > 1:
        w = r.shapes[1]
        return 2.0 * _elems(r.out_shapes[0]) * (_elems(w) // max(w[0], 1))
    return 0.0


def _is_collective(name: str) -> bool:
    return name.lower().startswith(("c10d::", "nccl:"))


def analyze_ops(trace: op_trace.OpTrace) -> Dict[str, float]:
    """{"flops", "elementwise_flops", "hbm_bytes", "collective_bytes",
    "coll_<kind>"} of a recorded step (``op_trace.record``)."""
    acc = {"flops": 0.0, "elementwise_flops": 0.0, "hbm_bytes": 0.0,
           "collective_bytes": 0.0}
    for r in trace.records:
        if r.kind != "op":
            continue
        out_bytes = sum(op_trace._bytes(s, d)
                        for s, d in zip(r.out_shapes, r.out_dtypes))
        if r.flops:                      # a folded kernel (K1)
            acc["flops"] += r.flops
            acc["hbm_bytes"] += r.nbytes + out_bytes
            continue
        acc["flops"] += _matmul_flops(r)
        w = _ELEMWISE_COST.get(_base(r.name))
        if w is not None and r.out_shapes:
            acc["elementwise_flops"] += w * _elems(r.out_shapes[0])
        if not (r.alias or r.name in _FREE or _is_collective(r.name)):
            acc["hbm_bytes"] += out_bytes
    for kind, b in op_trace.collective_instructions(trace):
        acc[f"coll_{kind}"] = acc.get(f"coll_{kind}", 0.0) + b
        acc["collective_bytes"] += b
        acc["hbm_bytes"] += b
    return acc


def collective_groups(trace: op_trace.OpTrace) -> List[Tuple[str, int, int]]:
    """(kind, group size, bytes) of every collective a dry run recorded
    (``dist.standin`` names each record with its group's size)."""
    out = []
    for r in trace.records:
        if r.kind == "op" and _is_collective(r.name) and "[" in r.name:
            kind = next((k for key, k in op_trace._COLLECTIVES
                         if key in r.name.lower()), None)
            group = int(r.name.split("[", 1)[1].rstrip("]"))
            out.append((kind, group, max(
                (op_trace._bytes(s, d) for s, d in zip(r.shapes, r.dtypes)),
                default=0)))
    return out
