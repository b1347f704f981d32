"""QuantizedTensor — the deployable storage format produced by CLAQ (port of
``repro.core.quantized``).

  * Columns are *permuted* so each Adaptive-Precision bit-class occupies a
    contiguous stripe; each stripe is a dense (packed codes, codebooks)
    pair with a single bit-width.
  * Outlier Reservation is stored structurally: per column, a fixed number
    of (row index, fp value) pairs with a valid count per column.
  * ``col_perm[p]`` = original column index stored at permuted position p.

Packed words are int32 tensors holding the reference's uint32 bits
(see core/packing.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.analysis import op_trace

from . import packing


@dataclasses.dataclass(frozen=True)
class QuantStripe:
    packed: torch.Tensor     # (packed_rows, n_cols) int32 (uint32 bits)
    codebook: torch.Tensor   # (n_cols, 2**bits) float32 (invalid slots = 0)
    bits: int

    @property
    def n_cols(self) -> int:
        return self.packed.shape[-1]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Quantized (rows, cols) matrix in paper layout (rows=out, cols=in)."""
    stripes: Tuple[QuantStripe, ...]
    col_perm: torch.Tensor    # (cols,) int32 — original col per permuted slot
    out_idx: torch.Tensor     # (k_out_max, cols) int32, ORIGINAL col order
    out_val: torch.Tensor     # (k_out_max, cols) float32
    out_count: torch.Tensor   # (cols,) int32 — valid entries per column
    shape: Tuple[int, int]    # (rows, cols)

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def tensors(self) -> Iterator[torch.Tensor]:
        for s in self.stripes:
            yield s.packed
            yield s.codebook
        yield from (self.col_perm, self.out_idx, self.out_val, self.out_count)

    @property
    def stack(self) -> Tuple[int, ...]:
        """Leading stack axes of the data leaves: () for one matrix, (E,)
        for MoE experts stacked as the reference's ``jnp.stack`` stacks
        them (``shape`` stays the per-matrix (rows, cols))."""
        return tuple(self.col_perm.shape[:-1])

    @op_trace.profiled(op_trace.DEQUANTIZE)
    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reference dequantization (the oracle the kernels test against):
        (*stack, rows, cols) in ``dtype``, one batched pass over a stack.
        Codebook and outlier values are cast to ``dtype`` before they are
        placed, elementwise the reference's f32 result cast afterwards."""
        rows, cols = self.shape
        parts = [lookup_codes(s.codebook, packing.unpack_codes(
            s.packed, s.bits, rows), dtype) for s in self.stripes]
        Wp = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        # un-permute columns: position p holds original column col_perm[p]
        W = torch.zeros(self.stack + (rows, cols), dtype=dtype,
                        device=Wp.device)
        W.scatter_(-1, self.col_perm.long().unsqueeze(-2).expand(W.shape),
                   Wp)
        k = self.out_idx.shape[-2]
        valid = (torch.arange(k, device=W.device)[:, None]
                 < self.out_count.unsqueeze(-2))
        return place_outliers(W, torch.where(valid, self.out_idx, -1),
                              self.out_val)

    def effective_bits(self, include_codebooks: bool = False) -> float:
        """Storage bits per weight (per matrix of a stack, on average)."""
        rows, cols = self.shape
        n = int(np.prod(self.stack))
        code_bits = sum(packing.storage_bits_per_element(s.bits) * rows
                        * s.n_cols for s in self.stripes)
        outlier_bits = float(self.out_count.sum().item()) * 32.0 / n
        total = code_bits + outlier_bits
        if include_codebooks:
            total += sum(s.codebook.shape[-2] * s.codebook.shape[-1] * 16.0
                         for s in self.stripes)
        return total / (rows * cols)


def lookup_codes(codebook: torch.Tensor, codes: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``codebook[..., k, codes[..., r, k]]`` in ``dtype``: codebook
    (*stack, K, levels), codes (*stack, n, K) int32 (consumed) -> (*stack,
    n, K).  One ``index_select`` with an int32 flat index, so a stack of
    experts takes one pass and no int64 index as large as the weights."""
    K, levels = codebook.shape[-2:]
    base = torch.arange(codebook.numel() // levels, dtype=torch.int32,
                        device=codes.device) * levels
    idx = codes.add_(base.view(codebook.shape[:-2] + (1, K)))
    flat = codebook.to(dtype).reshape(-1)
    return flat.index_select(0, idx.reshape(-1)).view(codes.shape)


def place_outliers(W: torch.Tensor, idx: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """``W[..., idx[..., r, c], c] = val[..., r, c]`` where idx >= 0, in
    place, slot by slot (a later slot wins): W (*stack, rows, cols), idx /
    val (*stack, k, cols).  Each slot is one scatter along the row axis
    with one entry per column (an empty entry writes its own value back),
    so no host sync and no duplicate index."""
    for r in range(idx.shape[-2]):
        ok = (idx[..., r, :] >= 0).unsqueeze(-2)
        ri = torch.where(ok, idx[..., r:r + 1, :], 0).long()
        v = torch.where(ok, val[..., r:r + 1, :].to(W.dtype), W.gather(-2, ri))
        W.scatter_(-2, ri, v)
    return W


def stack_quantized(qts) -> QuantizedTensor:
    """Stack per-expert QuantizedTensors on a new leading axis (the
    reference's ``jnp.stack`` over the expert pytrees).  Refused, as
    ``jnp.stack`` refuses it, unless every member has the same stripe
    layout (bits and column count of each stripe) and outlier slots."""
    first = qts[0]

    def layout(q):
        return (tuple((s.bits, s.n_cols) for s in q.stripes),
                tuple(q.out_idx.shape), q.shape)
    if any(layout(q) != layout(first) for q in qts):
        raise ValueError(
            "cannot stack quantized experts whose stripe layouts differ: "
            f"{sorted({layout(q) for q in qts})}")
    stripes = tuple(QuantStripe(
        packed=torch.stack([q.stripes[i].packed for q in qts]),
        codebook=torch.stack([q.stripes[i].codebook for q in qts]),
        bits=s.bits) for i, s in enumerate(first.stripes))
    return QuantizedTensor(
        stripes=stripes,
        **{f: torch.stack([getattr(q, f) for q in qts])
           for f in ("col_perm", "out_idx", "out_val", "out_count")},
        shape=first.shape)


def build_quantized_tensor(
    codes: torch.Tensor,          # (rows, cols) int (original column order)
    codebooks: torch.Tensor,      # (cols, k_max) f32 with +inf invalid slots
    column_bits: np.ndarray,      # (cols,) host ints
    reserve_counts: np.ndarray,   # (cols,) host ints
    Q: torch.Tensor,              # (rows, cols) dequantized (outlier values)
    reserved_mask: torch.Tensor,  # (rows, cols) bool
) -> QuantizedTensor:
    """Assemble the deployment format from per-column codes, codebooks, bit
    allocation and reserved outliers."""
    rows, cols = codes.shape
    dev = codes.device
    column_bits = np.asarray(column_bits)
    reserve_counts = np.asarray(reserve_counts)

    # stripes in ascending bit order, original column order within a stripe
    stripes = []
    perm_parts = []
    for b in sorted(set(int(x) for x in column_bits.tolist())):
        idx = np.nonzero(column_bits == b)[0].astype(np.int64)
        perm_parts.append(idx)
        idx_t = torch.as_tensor(idx, device=dev)
        sub_codes = codes.index_select(1, idx_t)
        sub_cb = codebooks.index_select(0, idx_t)[:, : 2 ** b]
        sub_cb = torch.where(torch.isfinite(sub_cb), sub_cb,
                             torch.zeros((), dtype=sub_cb.dtype, device=dev))
        stripes.append(QuantStripe(packed=packing.pack_codes(sub_codes, b),
                                   codebook=sub_cb.float(), bits=b))
    col_perm = torch.as_tensor(np.concatenate(perm_parts).astype(np.int32),
                               device=dev)

    k_max = int(reserve_counts.max()) if reserve_counts.size else 0
    if k_max > 0:
        # reserved entries sort first (stable), so the first `count` slots
        # of each column hold its reserved rows in ascending row order
        order = torch.argsort(-reserved_mask.to(torch.int32), dim=0,
                              stable=True)
        out_idx = order[:k_max].to(torch.int32)
        out_val = torch.gather(Q, 0, order[:k_max]).float()
        out_count = torch.as_tensor(reserve_counts.astype(np.int32),
                                    device=dev)
    else:
        out_idx = torch.zeros((0, cols), dtype=torch.int32, device=dev)
        out_val = torch.zeros((0, cols), dtype=torch.float32, device=dev)
        out_count = torch.zeros((cols,), dtype=torch.int32, device=dev)

    return QuantizedTensor(stripes=tuple(stripes), col_perm=col_perm,
                           out_idx=out_idx, out_val=out_val,
                           out_count=out_count, shape=(rows, cols))
