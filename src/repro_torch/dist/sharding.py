"""Named sharding rules for params, batches and caches (port of
``repro.dist.sharding``).

A *rule* is ``rule(name, shape, cfg, ax) -> PartitionSpec``, applied per
leaf by ``tree_specs``.  Rules are divisibility-guarded so the same rule
set covers every arch family: a dimension is only sharded when the mesh
axis divides it, otherwise it stays replicated.

Trees are read in the reference's layout, under the reference's
``jax.tree_util.keystr`` names: ``convert.param_tree`` for a model (block
leaves are ``tree.LayerStack``s of per-layer tensors, so a leaf's shape
carries the reference's leading layer axis) and ``cache_tree`` for a slot
cache (the port's per-layer caches stacked the same way).  Those two maps
are the one place where port leaves meet reference names; the rules read
names only for ``_QUANT_LEAF_MARKERS`` and the cache fields.

CLAQ quantized leaves are NOT per-leaf shardable: a
``PreparedQuantizedTensor`` is a *unit* (packed code planes, per-group
codebooks, outlier tables and one fused gather index whose layouts are
coupled).  ``spec_for_quantized`` shards the unit along N instead: planes
split on their packed-row axis in whole (bn, bk) tiles (guarded by
``PreparedQuantizedTensor.shards_whole_tiles``), everything K-indexed or
row-index-valued replicated.  ``tree_specs`` expands quantized units into
their own (name, spec) entries.

``local_shard`` takes one rank's block of a leaf (the counterpart of
``jax.device_put`` onto a ``NamedSharding``); ``place_model`` applies the
serve rule to a live model in place (the engine's ``mesh=``).

A paged pool whose page rows "dp" divides splits into one block of rows
a "dp" rank (``pool_blocks``; ``PoolBlocks.owner`` maps a global page id
to its rank and row); the tables stay replicated, and ``page_route``
gives a rank its routes through the split pool (the pages its slots name
that another rank holds, and where each block of its view comes from),
which the engine rebuilds whenever the tables change.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.kernels.plan import PreparedQuantizedTensor, local_plan

from . import context as dctx

_UNITS = (QuantizedTensor, PreparedQuantizedTensor)

# small buffers of the recurrent families that their code reads whole: the
# token-shift mixes and the wkv's decay bias and bonus (rwkv), the causal
# conv and the SSD's per-head vectors (Mamba2).  The wkv and SSD scans and
# the conv run whole on every model rank (their state is not split over
# "model"), so these stay whole where the rule would split them.
WHOLE_BUFFERS = ("mix", "w_bias", "u_bonus", "conv_w", "conv_b", "a_log",
                 "dt_bias", "d_skip")

# buffers read as the kernel of a product (``modules.linear``): split on
# their out dim, as a ``Dense`` kernel is (the hybrid's site LoRAs)
_KERNEL_BUFFERS = ("kernel", "lora_a", "lora_b")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a leaf: None (replicated), an axis name,
    or a tuple of names (the dim is split over their product, row-major).
    Trailing dimensions left out are replicated, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class MeshAxes:
    """Resolved logical axes of a mesh ("dp" spans pod x data when
    present)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp_axes: Tuple[str, ...] = dctx.physical_axes(mesh, "dp")
        self.model_axes: Tuple[str, ...] = dctx.physical_axes(mesh, "model")
        self.dp_size: int = dctx._axis_size(mesh, "dp")
        self.model_size: int = dctx._axis_size(mesh, "model")

    @property
    def dp(self):
        return dctx.spec_entry(self.mesh, "dp")

    @property
    def model(self):
        return dctx.spec_entry(self.mesh, "model")


def _shardable(dim: int, size: int) -> bool:
    return size > 1 and dim >= size and dim % size == 0


# leaf fields of QuantizedTensor / PreparedQuantizedTensor / PlanGroup — a
# per-leaf rule must never invent a spec for these (see spec_for_quantized)
_QUANT_LEAF_MARKERS = (".groups[", ".planes[", ".gather_idx", ".codebook",
                       ".out_idx", ".out_val", ".stripes[", ".col_perm",
                       ".out_count", ".packed", ".x_idx")


def is_unit(leaf) -> bool:
    """A quantized unit: one QuantizedTensor / PreparedQuantizedTensor, or
    a ``LayerStack`` of them (the reference's layer-stacked unit)."""
    if isinstance(leaf, tree_lib.LayerStack):
        return bool(leaf) and isinstance(leaf[0], _UNITS)
    return isinstance(leaf, _UNITS)


def unit_leaves(q) -> List[Tuple[str, torch.Tensor]]:
    """(keystr suffix, tensor) of one quantized unit's data leaves, in the
    reference's flatten order (``.groups[g].planes[p]``, ``.codebook``,
    ``.out_idx``, ``.out_val``, ``.x_idx``, then ``.gather_idx``; a raw
    QuantizedTensor's ``.stripes[s].packed`` ... ``.out_count``)."""
    if isinstance(q, QuantizedTensor):
        return tree_lib.flatten(q)
    out = []
    for gi, g in enumerate(q.groups):
        for pi, p in enumerate(g.planes):
            out.append((f".groups[{gi}].planes[{pi}]", p))
        for f in ("codebook", "out_idx", "out_val", "x_idx"):
            t = getattr(g, f)
            if t is not None:
                out.append((f".groups[{gi}].{f}", t))
    out.append((".gather_idx", q.gather_idx))
    return out


def leaf_shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape in the reference's layout (a ``LayerStack`` has the
    leading layer axis)."""
    if isinstance(leaf, tree_lib.LayerStack):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def spec_for_quantized(q, ax: MeshAxes) -> List[Tuple[str, PartitionSpec]]:
    """(suffix, spec) of every data leaf of one quantized unit ``q`` (a
    ``LayerStack`` of units: the leading layer axis is part of each
    leaf's rank).

    PreparedQuantizedTensor: sharded as a unit along N over "model" —
      * code planes split on their packed-row axis (axis -2; one packed
        word = 32/width consecutive rows of one column, and bn is a
        multiple of the 32-row word, so a bn-aligned split is word-aligned
        and every shard keeps whole (bn, bk) tiles);
      * codebooks, outlier tables (whose idx *values* are global row
        numbers), ``gather_idx`` and the per-group ``x_idx`` block tables
        are K-indexed: replicated;
      * guarded by ``shards_whole_tiles(model_size)``: when the tile count
        does not divide, the WHOLE unit stays replicated — never torn;
      * stacked (L, ...) / (L, E, ...) leaves shard the same axis -2.

    Raw QuantizedTensor: replicated as a unit (3-bit packs two planes
    concatenated along packed rows, so no row split is tile-clean)."""
    stacked = isinstance(q, tree_lib.LayerStack)
    unit = q[0] if stacked else q
    if not isinstance(unit, _UNITS):
        raise TypeError(f"not a quantized unit: {type(unit)}")
    lead = 1 if stacked else 0
    shard = (isinstance(unit, PreparedQuantizedTensor)
             and ax.model_size > 1
             and unit.shards_whole_tiles(ax.model_size))
    out = []
    for suffix, t in unit_leaves(unit):
        if shard and ".planes[" in suffix:
            ndim = t.dim() + lead
            entries = [None] * ndim
            entries[ndim - 2] = ax.model
            out.append((suffix, PartitionSpec(*entries)))
        else:
            out.append((suffix, PartitionSpec()))
    return out


def spec_for_param(name: str, shape, cfg, ax: MeshAxes) -> PartitionSpec:
    """Tensor-parallel params: shard the largest model-divisible dimension
    over "model"; everything else replicated.  Covers dense kernels
    (in, out), stacked (L, in, out), and embeddings (vocab, d).  Quantized
    leaves are routed through ``spec_for_quantized`` by ``tree_specs``;
    raw quantized internals mapped through this rule stay replicated."""
    if not shape or ax.model_size <= 1:
        return PartitionSpec()
    if any(m in name for m in _QUANT_LEAF_MARKERS):
        return PartitionSpec()
    candidates = [d for d, dim in enumerate(shape)
                  if _shardable(dim, ax.model_size)]
    if not candidates:
        return PartitionSpec()
    best = max(candidates, key=lambda d: shape[d])
    entries = [None] * len(shape)
    entries[best] = ax.model
    return PartitionSpec(*entries)


def spec_for_param_serve(name: str, shape, cfg, ax: MeshAxes
                         ) -> PartitionSpec:
    """Serving keeps the training TP layout (decode is weight-bound; the
    all-gather of a replicated layout would dominate the step)."""
    return spec_for_param(name, shape, cfg, ax)


def spec_for_batch(name: str, shape, cfg, ax: MeshAxes) -> PartitionSpec:
    """Batches shard their leading (global batch) dimension over "dp"."""
    if not shape or not _shardable(shape[0], ax.dp_size):
        return PartitionSpec()
    return PartitionSpec(ax.dp)


_POOL_FIELDS = ("kp", "vp", "cp", "pp", "k_scale", "v_scale", "c_scale",
                "p_scale")


def spec_for_cache(name: str, shape, cfg, ax: MeshAxes) -> PartitionSpec:
    """KV/state caches in the reference's stacked layout — (L, B, ...)
    data, (L, B) fill counters — so the batch (serving slot) axis is axis
    1, sharded over "dp".  The KV head axis of plain attention caches
    ((L, B, S, KH, D) leaves named k/v, and the encdec cross_k/cross_v
    banks) additionally shards over "model", matching head-parallel
    attention; every other axis stays replicated.  Paged pools
    ((L, n_pages+1, page_size, ...)) shard their PAGE axis over "dp" and
    kp/vp heads over "model"; the (L, B, max_pages) tables replicate."""
    if not shape:
        return PartitionSpec()
    field = name.rsplit(".", 1)[-1] if "." in name else name
    if field == "table":
        return PartitionSpec()
    entries = [None] * len(shape)
    if field in _POOL_FIELDS:
        if len(shape) >= 2 and _shardable(shape[1], ax.dp_size):
            entries[1] = ax.dp
        if (field in ("kp", "vp") and len(shape) == 5
                and _shardable(shape[-2], ax.model_size)):
            entries[-2] = ax.model
        return PartitionSpec(*entries)
    batch_axis = 1 if len(shape) >= 2 else 0
    if _shardable(shape[batch_axis], ax.dp_size):
        entries[batch_axis] = ax.dp
    if (field in ("k", "v", "cross_k", "cross_v") and len(shape) == 5
            and _shardable(shape[-2], ax.model_size)):
        entries[-2] = ax.model
    return PartitionSpec(*entries)


def flatten_units(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``tree.flatten`` that stops at quantized units (a unit, or a
    ``LayerStack`` of them, is one entry)."""
    if tree is None:
        return []
    if is_unit(tree) or not tree_lib._is_container(tree):
        return [(prefix, tree)]
    out = []
    for name, child in tree_lib._children(tree):
        out.extend(flatten_units(child, prefix + name))
    return out


def tree_specs(tree, rule, cfg, mesh) -> List[Tuple[str, PartitionSpec]]:
    """(keystr name, spec) of every leaf of ``tree`` (reference layout), in
    flatten order; quantized units expand to one entry per data leaf."""
    ax = MeshAxes(mesh)
    out = []
    for name, leaf in flatten_units(tree):
        if is_unit(leaf):
            out.extend((name + s, spec)
                       for s, spec in spec_for_quantized(leaf, ax))
        else:
            out.append((name, rule(name, leaf_shape(leaf), cfg, ax)))
    return out


def cache_tree(cache, cfg):
    """A slot cache (the port's flat list of per-layer caches) in the
    reference's layout: one cache of ``LayerStack`` leaves (an encdec
    cache's self-attention list too); the hybrid's
    ``{"attn": sites, "mamba": layers}``; an ``EncDecCache`` with its
    ``self_kv`` stacked over decoder layers (``.self_kv.{k,v,length}``)
    beside its ``cross_k``/``cross_v`` banks (L_dec, B, S_src, KH, hd) and
    ``enc_len`` (B,).  The leaves are the cache's own tensors (a paged
    cache's shared table appears once a layer)."""
    def stacked(caches):
        first = caches[0]
        return type(first)(*(
            None if getattr(first, f) is None
            else tree_lib.LayerStack(getattr(c, f) for c in caches)
            for f in first._fields))

    if cfg.family == "hybrid":
        n = cfg.n_layers
        return {"attn": stacked(list(cache[n:])),
                "mamba": stacked(list(cache[:n]))}
    if hasattr(cache, "self_kv"):
        return cache._replace(self_kv=stacked(list(cache.self_kv)))
    return stacked(list(cache))


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def entry_block(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(parts, index) of one spec entry: the product of its axes' sizes
    and this rank's row-major position among them."""
    shape = dctx.mesh_shape(mesh)
    parts, index = 1, 0
    for a in _entry_axes(entry):
        parts *= shape[a]
        index = index * shape[a] + coords.get(a, 0)
    return parts, index


def local_shard(leaf: torch.Tensor, spec, mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` (a contiguous copy when
    any dim splits, else ``leaf`` itself)."""
    out = leaf
    for d, entry in enumerate(spec):
        parts, index = entry_block(entry, mesh, coords)
        if parts > 1:
            n = leaf.shape[d] // parts
            out = out.narrow(d, index * n, n)
    return out if out is leaf else out.contiguous()


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along every dim of a ``DeviceMesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def place_model(model, cfg, mesh) -> Dict[str, int]:
    """Replace, IN PLACE, every tensor of ``model`` that
    ``spec_for_param_serve`` splits over "model" by this rank's block, and
    every quantized unit it splits by its shard-local plan
    (``kernels.plan.local_plan``).  A placed tensor carries
    ``_model_shard = (dim, parts, index)``, which the sharded layers read
    (``dist.collectives``).  Returns {"tensors": n, "units": n} placed.

    Two departures from the rule, so that no product sums partial products
    across ranks (tokens stay bitwise the single device's) and no weight
    moves at use: a dense kernel ((in, out), or an (E, in, out) expert
    stack; the hybrid's site LoRAs) the rule splits on any dim but its out
    dim (the contraction dim, which the largest-dim pick takes for a
    square or a wide-input matrix; an expert stack's E) is split on its
    out dim instead, or kept whole when that dim does not divide; a tied
    embedding split on its model dim (contracted by the logits) is split
    on vocab instead.  And the ``WHOLE_BUFFERS`` of the recurrent families
    stay whole.
    The reference's stacked layer axis is never split by the serve rule
    for a served config; a spec that splits it is refused.  Tensors and
    plans placed already are left as they are."""
    from repro_torch import convert
    ax = MeshAxes(mesh)
    coords = mesh_coords(mesh)
    index = coords.get("model", 0)
    tensor_split: Dict[int, Any] = {}
    unit_split: Dict[int, int] = {}
    for name, leaf in flatten_units(convert.param_tree(model, cfg)):
        stacked = isinstance(leaf, tree_lib.LayerStack)
        members = list(leaf) if stacked else [leaf]
        if is_unit(leaf):
            specs = spec_for_quantized(leaf, ax)
            if any(e is not None for _, s in specs for e in s):
                for u in members:
                    unit_split[id(u)] = ax.model_size
            continue
        spec = spec_for_param_serve(name, leaf_shape(leaf), cfg, ax)
        if stacked and spec and spec[0] is not None:
            raise NotImplementedError(
                f"{name}: spec {spec} splits the layer axis")
        # the param rules split one dim, over "model"
        dims = [d for d, e in enumerate(spec[1:] if stacked else spec)
                if e is not None]
        for t in members if dims else ():
            tensor_split[id(t)] = (dims[0], ax.model_size)
    n_t = n_u = 0
    tied = getattr(cfg, "tie_embeddings", False)
    for m in model.modules():
        for bname, t in list(m._buffers.items()):
            split = None if t is None else tensor_split.get(id(t))
            if (split is None or hasattr(t, "_model_shard")
                    or bname in WHOLE_BUFFERS):
                continue
            dim, parts = split
            # a kernel splits on its out dim (never a contraction dim or
            # an expert stack's E), a tied embedding on vocab, or the
            # tensor stays whole
            want = (t.dim() - 1 if bname in _KERNEL_BUFFERS else
                    {"embedding": 0 if tied else dim}.get(bname, dim))
            if want != dim:
                dim = want
                if not _shardable(t.shape[dim], parts):
                    continue
            n = t.shape[dim] // parts
            local = t.narrow(dim, index * n, n).contiguous()
            local._model_shard = (dim, parts, index)
            m._buffers[bname] = local
            n_t += 1
        kernel = getattr(m, "kernel", None)
        if (isinstance(kernel, PreparedQuantizedTensor)
                and kernel.shard is None and id(kernel) in unit_split):
            m.kernel = local_plan(kernel, unit_split[id(kernel)], index)
            n_u += 1
    return {"tensors": n_t, "units": n_u}


class PoolBlocks(NamedTuple):
    """How a paged pool's page rows split over "dp": ``parts`` ranks hold
    ``rows`` rows each, in ``entry_block`` order; this rank is ``index``."""
    parts: int
    index: int
    rows: int

    def owner(self, page: int) -> Tuple[int, int]:
        """(the "dp" rank that holds global page ``page``, its row
        there)."""
        return divmod(int(page), self.rows)


def pool_blocks(n_rows: int, cfg, mesh) -> Optional[PoolBlocks]:
    """The split of a pool of ``n_rows`` page rows over "dp" under
    ``spec_for_cache``, or None where the pool stays whole."""
    entry = spec_for_cache(".kp", (1, n_rows), cfg, MeshAxes(mesh))[1]
    if entry is None:
        return None
    parts, index = entry_block(entry, mesh, mesh_coords(mesh))
    return PoolBlocks(parts, index, n_rows // parts)


def page_route(tables: np.ndarray, blocks: PoolBlocks, rows_split: bool,
               device):
    """This rank's ``models.layers.PageRoute`` through a pool split by
    ``blocks``, from the host's (n_slots, max_pages) page tables: the
    pages each rank's slots name (its block of the slots where
    ``rows_split``, else every slot) and another rank holds are the
    exchange's, each sent once a rank however often it is named; scratch
    (the last page) is never sent and reads as zeros."""
    from repro_torch.models.layers import PageRoute
    D, me, P = blocks
    scratch = D * P - 1
    per = tables.shape[0] // D if rows_split else tables.shape[0]

    def slots_of(r):
        return tables[r * per:(r + 1) * per] if rows_split else tables

    need = [sorted(set(slots_of(r).ravel().tolist()) - {scratch})
            for r in range(D)]
    counts = tuple(tuple(0 if s == d else
                         sum(1 for p in need[d] if p // P == s)
                         for d in range(D)) for s in range(D))
    send = [p - me * P for d in range(D) if d != me
            for p in need[d] if p // P == me]
    recv = [p for s in range(D) if s != me for p in need[me] if p // P == s]
    at = {p: i for i, p in enumerate(recv)}
    mine = slots_of(me)
    local = (mine // P == me) & (mine != scratch)
    flat = mine.ravel()
    fix = np.flatnonzero(~local.ravel())
    src = [len(recv) if flat[i] == scratch else at[int(flat[i])]
           for i in fix]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64).reshape(np.shape(a)),
                               device=device)
    return PageRoute(
        table=dev(mine), first=me * P, rows=P, scratch=scratch,
        rows_split=rows_split, counts=counts, send=dev(send),
        view=dev(np.where(local, mine - me * P, 0)), fix_pos=dev(fix),
        fix_src=dev(src))


def place_cache(cache, cfg, mesh, slots: bool = True):
    """This rank's blocks of a slot cache (the port's flat per-layer list,
    or an ``EncDecCache``) under ``spec_for_cache``, read in the
    reference's layout (``cache_tree``): slots and a paged pool's page
    rows over "dp" where it divides them.  With ``slots=False`` (a
    prefill fragment whose rows every data rank prefills) the "dp"
    splits are dropped and only "model" splits apply.  A tensor shared by
    several layers (a paged cache's table) stays shared."""
    ax = MeshAxes(mesh)
    coords = mesh_coords(mesh)
    memo: Dict[int, torch.Tensor] = {}

    def block(name: str, t: torch.Tensor, layers: int = 0) -> torch.Tensor:
        """``t``'s block; ``layers`` > 0: ``t`` is one layer of a leaf
        the reference stacks over that many layers."""
        lead = (layers,) if layers else ()
        spec = spec_for_cache(name, lead + tuple(t.shape), cfg, ax)
        spec = tuple(e if slots or e != ax.dp else None
                     for e in spec)[len(lead):]
        if id(t) not in memo:
            memo[id(t)] = local_shard(t, spec, mesh, coords)
        return memo[id(t)]

    def per_layer(prefix: str, caches: List) -> List:
        fields = [f for f in caches[0]._fields
                  if getattr(caches[0], f) is not None]
        return [c._replace(**{f: block(f"{prefix}.{f}", getattr(c, f),
                                       len(caches)) for f in fields})
                for c in caches]

    if hasattr(cache, "self_kv"):
        return cache._replace(
            self_kv=per_layer(".self_kv", list(cache.self_kv)),
            **{f: block(f".{f}", getattr(cache, f))
               for f in ("cross_k", "cross_v", "enc_len")})
    if cfg.family == "hybrid":
        n = cfg.n_layers
        return (per_layer("['mamba']", list(cache[:n]))
                + per_layer("['attn']", list(cache[n:])))
    return per_layer("", list(cache))
