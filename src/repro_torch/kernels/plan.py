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
keeps one tensor per layer, so every plan here is a per-matrix plan.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quantized import QuantizedTensor

from . import ref

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
        return self.codebook.shape[0]


@dataclasses.dataclass(frozen=True)
class PreparedQuantizedTensor:
    """Deployment format: one gather index + one padded group per bit-width."""
    groups: Tuple[PlanGroup, ...]
    gather_idx: torch.Tensor   # (sum k_padded,) int32; == cols for padding
    shape: Tuple[int, int]     # (rows, cols) of the logical matrix
    n_padded: int              # rows padded to the N block
    bn: int                    # N block size (layout fact)

    @property
    def rows(self) -> int:
        return self.shape[0]

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

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantization from the prepared layout (plan-vs-tensor oracle)."""
        rows, cols = self.shape
        dev = self.gather_idx.device
        W = torch.zeros((rows, cols + 1), dtype=torch.float32, device=dev)
        off = 0
        for g in self.groups:
            Wg = ref.ref_apply_outliers(
                ref.ref_dequant_planes(g.planes, g.codebook, g.bits, rows),
                g.out_idx, g.out_val)
            idx = self.gather_idx[off:off + g.k_padded].long()
            W[:, idx] = Wg
            off += g.k_padded
        return W[:, :cols].to(dtype)


def validated_outliers(qt: QuantizedTensor):
    """Outlier planes in stripe-permuted column order, invalid slots -1."""
    if qt.out_idx.shape[0] == 0:
        return None, None
    k = qt.out_idx.shape[0]
    perm = qt.col_perm.long()
    idx_p = qt.out_idx[:, perm]
    val_p = qt.out_val[:, perm]
    cnt_p = qt.out_count[perm]
    valid = torch.arange(k, device=cnt_p.device)[:, None] < cnt_p[None, :]
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
    [s0, s0 + k_cols) with s0 a multiple of the group's bk."""
    perm = qt.col_perm.cpu().numpy()
    starts = []
    for bits, members, k_cols, g_bk, _k_padded in layout:
        idx = np.concatenate(
            [perm[o:o + qt.stripes[si].n_cols] for o, si in members])
        s0 = int(idx[0])
        ok = s0 % g_bk == 0 and np.array_equal(idx, np.arange(k_cols) + s0)
        starts.append(s0 if ok else None)
    return starts


def prepare_for_inference(qt: QuantizedTensor, *, bn: int = DEFAULT_BN,
                          bk: int = DEFAULT_BK) -> PreparedQuantizedTensor:
    """Compile ``qt`` into the fused deployment layout.  bn/bk are upper
    bounds, shrunk to the tensor (bn to N rounded to the 32-row packing
    word, bk per group to its fused K rounded to 128)."""
    if qt.stripes[0].packed.ndim != 2:
        raise ValueError("prepare_for_inference takes one (unstacked) "
                         "matrix; convert layer stacks per layer first")
    layout = _static_group_layout(qt.stripes, bk)
    return _build_plan(qt, bn=bn, layout=layout,
                       x_starts=_aligned_x_starts(qt, layout))


def _build_plan(qt: QuantizedTensor, *, bn: int, layout,
                x_starts) -> PreparedQuantizedTensor:
    rows = qt.rows
    bn = min(bn, round_up(rows, 32))
    n_padded = round_up(rows, bn)
    oi, ov = validated_outliers(qt)

    groups = []
    idx_parts = []
    for (bits, members, k_cols, g_bk, k_padded), x_start \
            in zip(layout, x_starts):
        planes = []
        for wi, w in enumerate(packing.plane_widths(bits)):
            cpw = 32 // w
            p = torch.cat([packing.split_planes(qt.stripes[si].packed, bits,
                                                rows)[wi]
                           for _, si in members], dim=1)
            p = F.pad(p, (0, k_padded - k_cols, 0, n_padded // cpw
                          - p.shape[0]))
            planes.append(p.contiguous())

        cb = torch.cat([qt.stripes[si].codebook for _, si in members], dim=0)
        cb = F.pad(cb.float(), (0, 0, 0, k_padded - k_cols)).contiguous()

        g_oi = g_ov = None
        if oi is not None:
            g_oi = torch.cat([oi[:, o:o + qt.stripes[si].n_cols]
                              for o, si in members], dim=1)
            g_ov = torch.cat([ov[:, o:o + qt.stripes[si].n_cols]
                              for o, si in members], dim=1)
            g_oi = F.pad(g_oi, (0, k_padded - k_cols), value=-1).contiguous()
            g_ov = F.pad(g_ov, (0, k_padded - k_cols)).contiguous()

        idx = torch.cat([qt.col_perm[o:o + qt.stripes[si].n_cols]
                         for o, si in members]).to(torch.int32)
        idx = F.pad(idx, (0, k_padded - k_cols), value=qt.cols)
        idx_parts.append(idx)

        groups.append(PlanGroup(
            planes=tuple(planes), codebook=cb, out_idx=g_oi, out_val=g_ov,
            x_idx=(None if x_start is not None
                   else idx.reshape(k_padded // g_bk, g_bk).contiguous()),
            bits=bits, bk=g_bk, k_cols=k_cols, x_start=x_start))

    return PreparedQuantizedTensor(
        groups=tuple(groups), gather_idx=torch.cat(idx_parts).contiguous(),
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
