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

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reference dequantization (the oracle the kernels test against)."""
        rows, cols = self.shape
        parts = []
        for s in self.stripes:
            codes = packing.unpack_codes(s.packed, s.bits, rows).long()
            parts.append(torch.gather(s.codebook.float().T, 0, codes))
        Wp = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        # un-permute columns: position p holds original column col_perm[p]
        W = torch.zeros((rows, cols), dtype=torch.float32,
                        device=Wp.device)
        W[:, self.col_perm.long()] = Wp
        k = self.out_idx.shape[0]
        if k > 0:
            valid = (torch.arange(k, device=W.device)[:, None]
                     < self.out_count[None, :])
            colj = torch.arange(cols, device=W.device).expand(k, cols)
            # slot order: a later valid slot overwrites an earlier one
            for r in range(k):
                v = valid[r]
                W[self.out_idx[r][v].long(), colj[r][v]] = self.out_val[r][v]
        return W.to(dtype)

    def effective_bits(self, include_codebooks: bool = False) -> float:
        rows, cols = self.shape
        code_bits = sum(packing.storage_bits_per_element(s.bits) * rows
                        * s.n_cols for s in self.stripes)
        outlier_bits = float(self.out_count.sum().item()) * 32.0
        total = code_bits + outlier_bits
        if include_codebooks:
            total += sum(s.codebook.shape[0] * s.codebook.shape[1] * 16.0
                         for s in self.stripes)
        return total / (rows * cols)


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
