"""Builders that turn a live ``ServingEngine`` into the context dict the
step-artifact and trace rules consume, plus ``verify_engine`` — the
one-call gate behind ``ServingEngine(verify_contracts=True)`` (port of
``repro.analysis.artifacts``).

The reference lowers its decode jit and reads the HLO; the port runs one
decode step under the profiler instead (``decode_ops``, the counterpart
of ``lowered_decode_text``), on a clone of the slot cache, so the engine
is left as it was.  For the gather-parity rule it builds a *dense twin* —
the same engine over the dequantized weights — whose profiled decode is
the gather baseline.  Everything else (plan stats, shard thresholds,
pool-slice limits, compile budgets) is cheap host-side walking.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantized import QuantizedTensor
from repro_torch.dist import collectives
from repro_torch.dist.context import mesh_shape, use_mesh
from repro_torch.kernels.plan import PreparedQuantizedTensor
from repro_torch.models import modules as nn_mod

from . import op_trace
from .core import ContractViolation, Report, run_rules
from .op_rules import HLO_RULES
from .trace_rules import TRACE_RULES

_QUANT_TYPES = (QuantizedTensor, PreparedQuantizedTensor)

# Cache-pool leaf names (mirrors serve.engine._POOL_SRC — duplicated here
# to keep analysis importable without pulling in the engine module).
_POOL_LEAVES = ("kp", "vp", "cp", "pp")


def _quant_modules(params) -> List[nn_mod.Dense]:
    return [m for m in params.modules() if isinstance(m, nn_mod.Dense)
            and isinstance(getattr(m, "kernel", None), _QUANT_TYPES)]


def plan_stats(params, n_slots: int = 8) -> Dict[str, Any]:
    """Plan-tree stats for the gather-parity rule: how many permuted
    (x-indexed) groups exist across all prepared leaves, and the worst
    group K block.  ``bm``/``itemsize`` are the reference's tile facts,
    kept so the two packages' contexts have the same keys."""
    n_permuted = 0
    max_bk = 0
    has_plans = False
    for m in _quant_modules(params):
        leaf = m.kernel
        if not isinstance(leaf, PreparedQuantizedTensor):
            continue
        has_plans = True
        permuted = [g for g in leaf.groups if g.x_start is None]
        n_permuted += len(permuted)
        if permuted:
            max_bk = max(max_bk, max(g.bk for g in permuted))
    return {"has_plans": has_plans, "n_permuted_groups": n_permuted,
            "max_bk": max_bk, "bm": max(8, n_slots), "itemsize": 4}


def weight_shard_threshold(params, model_parts: int) -> Optional[int]:
    """Largest sharded plan-plane payload in bytes — the all-gather rule's
    threshold.  None when no quantized unit actually shards (a plan shards
    along N in whole word-aligned tiles, as the reference's
    ``shards_whole_tiles``; replicated plans move at load, not per step)."""
    if model_parts <= 1:
        return None
    best: Optional[int] = None
    for m in _quant_modules(params):
        leaf = m.kernel
        if not isinstance(leaf, PreparedQuantizedTensor):
            continue
        # a shard-local plan (an engine on a mesh) counts its whole plane
        if leaf.shard is not None:
            parts = leaf.shard.parts
        elif leaf.shards_whole_tiles(model_parts):
            parts = 1
        else:
            continue
        for g in leaf.groups:
            for p in g.planes:
                b = p.numel() * 4 * parts
                best = b if best is None else max(best, b)
    return best


def dense_twin_params(params):
    """The engine's model with every quantized kernel replaced by its
    dequantized dense form (in the model's dtype) — the baseline the
    gather-parity rule profiles.  Every other tensor is shared with
    ``params``; only the dense kernels are new."""
    memo = {id(t): t for t in nn_mod.module_tensors(params)}
    twin = copy.deepcopy(params, memo)
    dtype = params.embedding.dtype
    for m in _quant_modules(twin):
        W = m.kernel.dequantize(dtype)
        sh = getattr(m.kernel, "shard", None)
        if sh is not None:
            # a shard-local plan: the whole matrix (an expert stack's
            # every matrix), gathered once here
            W = collectives.all_gather(
                F.pad(W, (0, 0, 0, m.kernel.n_padded - W.shape[-2])),
                dim=-2)[..., :sh.rows, :]
        m.set_kernel(W.transpose(-1, -2).contiguous())
    return twin


def _batch_buckets(n_slots: int) -> int:
    """Distinct bucketed admission batch sizes: next-power-of-2 capped at
    n_slots (mirrors the engine's ``Bb`` computation in ``_admit``)."""
    return len({min(1 << (b - 1).bit_length(), n_slots)
                for b in range(1, n_slots + 1)})


def compile_budgets(engine) -> Dict[str, int]:
    """Per-call-kind upper bounds on distinct signatures (PR 2's
    contract).  Prefill budgets exist only under bucketing — with it off,
    every distinct prompt length legitimately runs its own shape."""
    out: Dict[str, int] = {}
    if engine.bucketing.enabled:
        shapes = engine.bucketing.max_traces() * _batch_buckets(
            engine.n_slots)
        out["prefill"] = shapes
        if engine.spec is not None:
            out["draft_prefill"] = shapes
    if getattr(engine, "chunked", None) is not None:
        # chunk calls have a fixed token axis (chunk_tokens); only the
        # batch bucket varies
        out["chunk_prefill"] = _batch_buckets(engine.n_slots)
        if engine.spec is not None:
            out["draft_chunk_prefill"] = _batch_buckets(engine.n_slots)
    # decode: the batched step shape plus the batch-1 resume replay
    out["decode"] = 2
    if engine.spec is not None:
        out["draft_decode"] = 2
        # one verify span shape per distinct γ the engine may run — the
        # degradation ladder's spec_half rung adds ceil(γ/2)
        out["verify"] = max(1, len(getattr(engine, "verify_gammas",
                                           {engine.spec.gamma})))
    return out


def trace_counts(engine) -> Dict[str, int]:
    """The engine's own counts of distinct call shapes (``stats()``'s
    ``*_traces``)."""
    shapes = engine.call_shapes
    out = {"prefill": engine.prefill_traces,
           "decode": len(shapes["decode"])}
    if engine.spec is not None:
        out.update(draft_prefill=len(shapes["draft_prefill"]),
                   draft_decode=len(shapes["draft_decode"]),
                   verify=len(shapes["verify"]))
    if getattr(engine, "chunked", None) is not None:
        out["chunk_prefill"] = len(shapes["chunk_prefill"])
        if engine.spec is not None:
            out["draft_chunk_prefill"] = len(shapes["draft_chunk_prefill"])
    return out


def _cache_tensors(cache):
    """(name, tensor) of every tensor leaf of a slot cache (a list of
    per-layer named tuples), named ``{layer}.{field}``."""
    for i, c in enumerate(cache):
        for f in c._fields:
            t = getattr(c, f)
            if isinstance(t, torch.Tensor):
                yield f"{i}.{f}", t


def _pool_slice_elems(engine) -> Optional[int]:
    """Element count of one layer's gathered int8 pool view — the widest
    s8->f32 copy legal on the decode path.  None when the engine holds
    no int8 pages (nothing to upcast)."""
    if getattr(engine, "kv_dtype", None) != "int8":
        return None
    best: Optional[int] = None
    for name, leaf in _cache_tensors(engine.cache):
        if name.split(".")[-1] in _POOL_LEAVES and leaf.dtype == torch.int8:
            feat = 1
            for d in leaf.shape[2:]:
                feat *= int(d)
            n = engine.n_slots * engine.max_len * feat
            best = n if best is None else max(best, n)
    return best


def _cache_leaf_bytes(engine) -> int:
    return max((t.numel() * t.element_size()
                for _, t in _cache_tensors(engine.cache)), default=0)


def _clone_cache(cache):
    if cache is None:
        return None
    return [type(c)(*(t.clone() if isinstance(t, torch.Tensor) else t
                      for t in c)) for c in cache]


def decode_ops(engine) -> op_trace.OpTrace:
    """The op trace of one vanilla decode step of ``engine`` (the
    counterpart of the reference's ``lowered_decode_text``): the engine's
    own ``_decode_batch`` over a clone of its slot cache (the target's
    decode alone, as the reference lowers it), profiled, with
    the storage of every cache leaf compared across the step (the leaves
    the step updated in place).  The engine's caches, counters and
    sentinel signatures are untouched; the sentinel records the step as a
    lowering, as the reference's ``lower_decode`` does."""
    cache = _clone_cache(engine.cache)
    # the fill counter is excluded: a (B,) int the step replaces, as the
    # reference's decode returns new counters
    before = {k: t.data_ptr() for k, t in _cache_tensors(cache)
              if not k.endswith(".length")}
    with torch.no_grad():
        (_, _, cache_out, _), trace = op_trace.capture(
            lambda: engine._decode_batch(cache, None, None),
            device=engine.device)
    after = dict(_cache_tensors(cache_out))
    trace.leaves = {k: after[k].data_ptr() == p for k, p in before.items()}
    engine.sentinel.observe_lowering("decode")
    return trace


def engine_context(engine, dense_engine=None) -> Dict[str, Any]:
    """Build the full rule context from a live engine (and, optionally, a
    dense twin engine supplying the gather baseline).  The port updates
    its cache in place, so ``donation_expected`` is always on.  On a mesh
    with a "model" axis, ``weight_shard_bytes`` is the largest sharded
    plane (``weight_shard_threshold``) and the collective rules read the
    step's c10d records; off a mesh they skip."""
    ctx: Dict[str, Any] = {
        "ops": {"decode": decode_ops(engine)},
        "plan": plan_stats(engine.params, n_slots=engine.n_slots),
        "cache_leaf_bytes": _cache_leaf_bytes(engine),
        "donation_expected": True,
        "sentinel": engine.sentinel,
        "compile_budget": compile_budgets(engine),
        "trace_counts": trace_counts(engine),
    }
    pool = _pool_slice_elems(engine)
    if pool is not None:
        ctx["pool_slice_elems"] = pool
    if engine.mesh is not None:
        thresh = weight_shard_threshold(
            engine.params, mesh_shape(engine.mesh).get("model", 1))
        if thresh is not None:
            ctx["weight_shard_bytes"] = thresh
    if dense_engine is not None:
        ctx["dense_ops"] = {"decode": decode_ops(dense_engine)}
    return ctx


def dense_twin_engine(engine):
    """A twin engine over the dequantized weights, matched on everything
    that shapes the decode step (slots, cache layout and dtype, guards,
    device)."""
    from repro_torch.serve.engine import ServingEngine
    kw: Dict[str, Any] = {}
    if engine._paged:
        kw = dict(kv_layout="paged", page_size=engine.page_size,
                  kv_pages=engine.n_pages, kv_dtype=engine.kv_dtype)
    return ServingEngine(
        dense_twin_params(engine.params), engine.cfg,
        n_slots=engine.n_slots, max_len=engine.max_len,
        dtype=engine._cache_dtype, prepare=False, guards=engine.guards,
        mesh=engine.mesh, device=engine.device, **kw)


def verify_engine(engine, dense_engine=None, *,
                  raise_on_error: bool = True,
                  subject: str = "engine") -> Report:
    """Run the step-artifact + trace rules against a live engine; raises
    ``ContractViolation`` on ERROR findings (the ``verify_contracts=True``
    init hook).  Builds the dense twin for the gather-parity rule when the
    caller did not pass ``dense_engine`` and the params hold plans; the
    twin is dropped before this returns."""
    with use_mesh(engine.mesh):
        if dense_engine is None and plan_stats(engine.params)["has_plans"]:
            dense_engine = dense_twin_engine(engine)
        ctx = engine_context(engine, dense_engine)
    del dense_engine
    report = run_rules(list(HLO_RULES) + list(TRACE_RULES), ctx,
                       subject=subject)
    if raise_on_error and not report.clean:
        raise ContractViolation(report)
    return report
