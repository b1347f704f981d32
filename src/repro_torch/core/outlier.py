"""Outlier Order — the column-wise quantization-sensitivity metric (paper
§3.2; port of ``repro.core.outlier``).

R_j = |{ i : |W_ij| > S * mean(|W|) }| / rows            (paper Eq. 3)

S is the "outlier standard" (paper Appendix B: S = 13).  The ranking of
R_j drives both Adaptive Precision and Outlier Reservation.  Counts are
exact: rankings come from stable argsorts, so ties break by index.
"""
from __future__ import annotations

import torch

DEFAULT_OUTLIER_STANDARD = 13.0


def outlier_ratio(W: torch.Tensor,
                  standard: float = DEFAULT_OUTLIER_STANDARD) -> torch.Tensor:
    """Per-column outlier ratio R_j (Eq. 3). W: (rows, cols) -> (cols,) f32,
    a count over ``rows`` divided in f32."""
    absW = W.float().abs()
    thresh = standard * absW.mean()
    return (absW > thresh).sum(dim=0, dtype=torch.float32) / W.shape[0]


def outlier_order(R: torch.Tensor) -> torch.Tensor:
    """Columns sorted by descending sensitivity; ties by column index."""
    return torch.argsort(-R, stable=True).to(torch.int32)


def _rank(order: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inverse permutation along ``dim``: rank[order[i]] = i."""
    ar = torch.arange(order.shape[dim], device=order.device)
    ar = ar.view([-1] + [1] * (order.dim() - 1)).expand_as(order)
    return torch.empty_like(ar).scatter_(dim, order.long(), ar)


def top_fraction_mask(R: torch.Tensor, fraction: float) -> torch.Tensor:
    """Boolean mask of the round(fraction * cols) most sensitive columns,
    by rank rather than by value threshold, so the count is exact even
    with ties."""
    n_top = int(round(fraction * R.shape[0]))
    return _rank(outlier_order(R)) < n_top


def topk_per_column_mask(W: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Boolean (rows, cols) mask of the ``counts[j]`` largest-|.| entries of
    each column (Outlier Reservation, §3.4); rank 0 is the largest, ties by
    row index."""
    order = torch.argsort(-W.abs(), dim=0, stable=True)
    return _rank(order, 0) < counts.to(W.device)[None, :].long()


def layer_outlier_ratio(W: torch.Tensor,
                        standard: float = DEFAULT_OUTLIER_STANDARD
                        ) -> torch.Tensor:
    """Whole-matrix outlier ratio (Appendix A / G)."""
    absW = W.float().abs()
    return (absW > standard * absW.mean()).float().mean()
