"""Ahead-of-time inference plans (port of ``repro.kernels.plan``): compile a
QuantizedTensor once, at load time, into the padded, fused layout the
dequant-GEMM kernel consumes.

  (a) code planes, codebooks and outlier tables are padded — K to the
      group's ``bk``, N to ``bn`` — with zero codebooks and idx=-1
      outliers in the padding, so padded slots contribute exactly zero;
  (b) the per-stripe column slicing is folded into ONE gather index over
      the activation's K axis (``gather_idx``, == cols for padding) and,
      per group, either a static ``x_start`` (the group's fused K order is
      original columns [x_start, x_start + k_cols): the kernel reads raw x
      with no indexing) or the ``x_idx`` per-``bk``-block tables;
  (c) outlier slots are pre-validated (count -> idx=-1 padding);
  (d) stripes are grouped by bit-width and concatenated along K, so a
      matmul is ONE kernel launch per distinct bit-width, chained through
      the kernel's ``acc`` operand.

``bn``/``bk`` are layout facts of the plan — how N and K are padded and
how ``x_idx`` is blocked — kept bit-for-bit equal to the reference's.  The
CUDA kernel picks its own tile (n_padded is a multiple of 32 and every
k_padded a multiple of 128, so any tile dividing those fits).

The reference prepares a layer-stacked tensor under ``vmap``; the port
keeps one tensor per layer, so a plan is a per-matrix plan, or, for MoE
experts, one plan stacked on a leading E axis (dequantized whole, never
run through the kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis import op_trace
from repro_torch.core import packing
from repro_torch.core.quantized import (QuantizedTensor, lookup_codes,
                                        place_outliers)

DEFAULT_BN = 128
DEFAULT_BK = 512


def round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """All same-bit-width stripes, concatenated along K and block-padded."""
    planes: Tuple[torch.Tensor, ...]  # per plane: (n_padded//cpw, k_padded)
    codebook: torch.Tensor            # (k_padded, 2**bits) f32, 0 at padding
    out_idx: Optional[torch.Tensor]   # (k_out, k_padded) int32, -1 = none
    out_val: Optional[torch.Tensor]   # (k_out, k_padded) f32
    x_idx: Optional[torch.Tensor]     # (k_padded//bk, bk) int32, or None
    bits: int
    bk: int                           # K block of this group (layout fact)
    k_cols: int                       # unpadded fused K of the group
    x_start: Optional[int] = None     # set iff fused K == original columns
    #                                   [x_start, x_start + k_cols)

    @property
    def k_padded(self) -> int:
        return self.codebook.shape[-2]


@dataclasses.dataclass(frozen=True)
class PlanShard:
    """Where a shard-local plan sits in its matrix: block ``index`` of
    ``parts`` equal row blocks of a plan of ``rows`` rows (``local_plan``)."""
    parts: int
    index: int
    rows: int


@dataclasses.dataclass(frozen=True)
class PreparedQuantizedTensor:
    """Deployment format: one gather index + one padded group per bit-width."""
    groups: Tuple[PlanGroup, ...]
    gather_idx: torch.Tensor   # (sum k_padded,) int32; == cols for padding
    shape: Tuple[int, int]     # (rows, cols) of the logical matrix
    n_padded: int              # rows padded to the N block
    bn: int                    # N block size (layout fact)
    shard: Optional[PlanShard] = None   # set on a shard-local plan: its
    #                                     rows are one N block of a matrix

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.n_padded // self.bn

    def shards_whole_tiles(self, parts: int) -> bool:
        """True iff splitting N into ``parts`` equal contiguous shards keeps
        whole (bn, bk) tiles on every shard: bn a multiple of the full
        32-row packing word (a width-1 plane packs 32 rows per word) and
        the tile count divisible by ``parts``.  The sharding rule's guard:
        otherwise the whole unit stays replicated, never torn."""
        return parts > 1 and self.bn % 32 == 0 and self.n_tiles % parts == 0

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def x_gather_free(self) -> bool:
        return all(g.x_start is not None for g in self.groups)

    def tensors(self) -> Iterator[torch.Tensor]:
        yield self.gather_idx
        for g in self.groups:
            yield from g.planes
            yield g.codebook
            for t in (g.out_idx, g.out_val, g.x_idx):
                if t is not None:
                    yield t

    @property
    def stack(self) -> Tuple[int, ...]:
        """Leading stack axes (() for one matrix, (E,) for stacked MoE
        experts, which are dequantized whole and never reach the
        kernel)."""
        return tuple(self.gather_idx.shape[:-1])

    def effective_bits(self, include_codebooks: bool = False) -> float:
        """Storage cost of the *unpadded* payload in bits an element
        (parity with ``QuantizedTensor.effective_bits`` up to outlier-count
        rounding): code planes over each group's real columns, 32 bits a
        valid outlier slot, and with ``include_codebooks`` 16 bits a
        codebook entry (a stacked plan: over all its members)."""
        rows, cols = self.shape
        members = 1
        for n in self.stack:
            members *= n
        total = 0.0
        for g in self.groups:
            total += (packing.storage_bits_per_element(g.bits) * rows
                      * g.k_cols * members)
            if g.out_idx is not None:
                total += 32.0 * float((g.out_idx[..., :g.k_cols] >= 0).sum())
            if include_codebooks:
                total += g.k_cols * g.codebook.shape[-1] * 16.0 * members
        return total / (rows * cols * members)

    @op_trace.profiled(op_trace.DEQUANTIZE)
    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantization from the prepared layout (plan-vs-tensor oracle;
        the MoE experts' weights): (*stack, rows, cols) in ``dtype``, one
        batched pass over a stack, values cast before they are placed."""
        rows, cols = self.shape
        dev = self.gather_idx.device
        W = torch.zeros(self.stack + (rows, cols), dtype=dtype, device=dev)
        off = 0
        for g in self.groups:
            Wg = lookup_codes(g.codebook, packing.unpack_planes(
                g.planes, g.bits, rows), dtype)
            if g.out_idx is not None:
                place_outliers(Wg, g.out_idx, g.out_val)
            # the group's padding columns (gather index == cols) are its
            # tail: only its first k_cols columns are placed
            idx = self.gather_idx[..., off:off + g.k_cols].long()
            W.scatter_(-1, idx.unsqueeze(-2).expand(
                self.stack + (rows, g.k_cols)), Wg[..., :g.k_cols])
            off += g.k_padded
        return W


def local_plan(pqt: PreparedQuantizedTensor, parts: int,
               index: int) -> PreparedQuantizedTensor:
    """Block ``index`` of ``parts`` of a plan split along N in whole tiles
    (``shards_whole_tiles(parts)``): each plane keeps its packed rows of
    the block (a stacked plan: on its axis -2, leading axes whole); the
    codebooks, ``gather_idx`` and ``x_idx`` are K-indexed and shared
    whole.  Outlier slots name global rows: each slot is rebased to the
    block, and a slot of another block becomes an empty one (-1, value
    0), so the local plan applies exactly its own rows' outliers in slot
    order.  ``dequantize`` of the blocks, concatenated, is the whole
    plan's."""
    if not pqt.shards_whole_tiles(parts):
        raise ValueError(
            f"plan of {pqt.n_tiles} tiles of bn={pqt.bn} does not split "
            f"into {parts} whole-tile shards")
    n_l = pqt.n_padded // parts
    lo = index * n_l
    groups = []
    for g in pqt.groups:
        planes = []
        for w, p in zip(packing.plane_widths(g.bits), g.planes):
            cpw = 32 // w
            planes.append(p[..., lo // cpw:(lo + n_l) // cpw, :]
                          .contiguous())
        oi, ov = g.out_idx, g.out_val
        if oi is not None:
            loc = oi.long() - lo
            ok = (oi >= 0) & (loc >= 0) & (loc < n_l)
            oi = torch.where(ok, loc, -1).to(torch.int32).contiguous()
            ov = torch.where(ok, ov, 0.0).contiguous()
        groups.append(dataclasses.replace(g, planes=tuple(planes),
                                          out_idx=oi, out_val=ov))
    return dataclasses.replace(
        pqt, groups=tuple(groups), shape=(min(n_l, pqt.rows - lo), pqt.cols),
        n_padded=n_l, shard=PlanShard(parts, index, pqt.rows))


def validated_outliers(qt: QuantizedTensor):
    """Outlier planes in stripe-permuted column order, invalid slots -1
    (per member of a stack)."""
    if qt.out_idx.shape[-2] == 0:
        return None, None
    k = qt.out_idx.shape[-2]
    perm = qt.col_perm.long().unsqueeze(-2)
    idx_p = torch.gather(qt.out_idx, -1, perm.expand(qt.out_idx.shape))
    val_p = torch.gather(qt.out_val, -1, perm.expand(qt.out_val.shape))
    cnt_p = torch.gather(qt.out_count.long(), -1, qt.col_perm.long())
    valid = (torch.arange(k, device=cnt_p.device)[:, None]
             < cnt_p.unsqueeze(-2))
    return (torch.where(valid, idx_p, -1).to(torch.int32),
            torch.where(valid, val_p, 0.0).float())


def _static_group_layout(stripes, bk: int):
    """Per-bit-width group layout from stripe metadata only:
    [(bits, [(perm_offset, stripe_index), ...], k_cols, g_bk, k_padded)]."""
    offsets = []
    off = 0
    for s in stripes:
        offsets.append(off)
        off += s.n_cols
    layout = []
    for bits in sorted({s.bits for s in stripes}):
        members = [(o, si) for si, (o, s) in enumerate(zip(offsets, stripes))
                   if s.bits == bits]
        k_cols = sum(stripes[si].n_cols for _, si in members)
        g_bk = min(bk, round_up(k_cols, 128))
        layout.append((bits, members, k_cols, g_bk, round_up(k_cols, g_bk)))
    return layout


def _aligned_x_starts(qt: QuantizedTensor, layout):
    """Per-group x_start, or None where the group needs index tables.  A
    group is aligned when its fused K order is exactly the original columns
    [s0, s0 + k_cols) with s0 a multiple of the group's bk (for a stack:
    in every member, as the reference decides it before its vmap)."""
    perm = qt.col_perm.cpu().numpy()
    flat = perm.reshape(-1, perm.shape[-1])
    starts = []
    for bits, members, k_cols, g_bk, _k_padded in layout:
        idx = np.concatenate(
            [flat[:, o:o + qt.stripes[si].n_cols] for o, si in members],
            axis=1)
        s0 = int(idx[0, 0])
        ok = s0 % g_bk == 0 and np.array_equal(
            idx, np.broadcast_to(np.arange(k_cols) + s0, idx.shape))
        starts.append(s0 if ok else None)
    return starts


def prepare_for_inference(qt: QuantizedTensor, *, bn: int = DEFAULT_BN,
                          bk: int = DEFAULT_BK) -> PreparedQuantizedTensor:
    """Compile ``qt`` into the fused deployment layout.  bn/bk are upper
    bounds, shrunk to the tensor (bn to N rounded to the 32-row packing
    word, bk per group to its fused K rounded to 128).  A stack (MoE
    experts, leading E axis) gives a stacked plan with one layout shared by
    every member, as the reference's vmap over the stack gives it."""
    layout = _static_group_layout(qt.stripes, bk)
    return _build_plan(qt, bn=bn, layout=layout,
                       x_starts=_aligned_x_starts(qt, layout))


def _build_plan(qt: QuantizedTensor, *, bn: int, layout,
                x_starts) -> PreparedQuantizedTensor:
    rows = qt.rows
    stack = qt.stack
    bn = min(bn, round_up(rows, 32))
    n_padded = round_up(rows, bn)
    oi, ov = validated_outliers(qt)

    def cols(t, o, si):            # a stripe's columns of a (..., K) leaf
        return t[..., o:o + qt.stripes[si].n_cols]

    groups = []
    idx_parts = []
    for (bits, members, k_cols, g_bk, k_padded), x_start \
            in zip(layout, x_starts):
        planes = []
        for wi, w in enumerate(packing.plane_widths(bits)):
            cpw = 32 // w
            p = torch.cat([packing.split_planes(qt.stripes[si].packed, bits,
                                                rows)[wi]
                           for _, si in members], dim=-1)
            p = F.pad(p, (0, k_padded - k_cols, 0, n_padded // cpw
                          - p.shape[-2]))
            planes.append(p.contiguous())

        cb = torch.cat([qt.stripes[si].codebook for _, si in members],
                       dim=-2)
        cb = F.pad(cb.float(), (0, 0, 0, k_padded - k_cols)).contiguous()

        g_oi = g_ov = None
        if oi is not None:
            g_oi = torch.cat([cols(oi, o, si) for o, si in members], dim=-1)
            g_ov = torch.cat([cols(ov, o, si) for o, si in members], dim=-1)
            g_oi = F.pad(g_oi, (0, k_padded - k_cols), value=-1).contiguous()
            g_ov = F.pad(g_ov, (0, k_padded - k_cols)).contiguous()

        idx = torch.cat([cols(qt.col_perm, o, si) for o, si in members],
                        dim=-1).to(torch.int32)
        idx = F.pad(idx, (0, k_padded - k_cols), value=qt.cols)
        idx_parts.append(idx)

        groups.append(PlanGroup(
            planes=tuple(planes), codebook=cb, out_idx=g_oi, out_val=g_ov,
            x_idx=(None if x_start is not None
                   else idx.reshape(stack + (k_padded // g_bk, g_bk))
                   .contiguous()),
            bits=bits, bk=g_bk, k_cols=k_cols, x_start=x_start))

    return PreparedQuantizedTensor(
        groups=tuple(groups),
        gather_idx=torch.cat(idx_parts, dim=-1).contiguous(),
        shape=qt.shape, n_padded=n_padded, bn=bn)


def prepare_tree(module: torch.nn.Module, *, bn: int = DEFAULT_BN,
                 bk: int = DEFAULT_BK) -> torch.nn.Module:
    """Replace, IN PLACE, every QuantizedTensor kernel of the module tree
    with its prepared plan (dense kernels and already-prepared plans are
    kept as they are); returns the module.  Engines call this once at load.
    In place so the unprepared tensors can be freed at full model size."""
    for m in module.modules():
        kernel = getattr(m, "kernel", None)
        if isinstance(kernel, QuantizedTensor):
            m.kernel = prepare_for_inference(kernel, bn=bn, bk=bk)
    return module
