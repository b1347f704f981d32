"""1-D K-Means codebook generation (paper §3.1; port of
``repro.core.kmeans``).

Deterministic Lloyd iterations on each column of a weight matrix:
  * init at mid-quantiles of the sorted column (no RNG);
  * a fixed iteration count;
  * a number of valid centroids ``k_valid <= k_max`` per column (Adaptive
    Precision), invalid slots parked at +inf so they are never nearest;
  * per-element weights (0 excludes an element: Outlier Reservation).

The reference vmaps one column's routine over the columns; here the
routine takes a batch of columns, (B, n), so ``kmeans_1d`` is the batch of
one and ``kmeans_columns`` the batch of all.  Two facts keep it equal to
the reference: the median of an even count averages the two middle values
(``jnp.median``; ``torch.median`` would return the lower one), and argmin
ties go to the first index in both libraries.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

IntOrTensor = Union[int, torch.Tensor]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, (lo + hi) * 0.5 of the two middle values
    as ``jnp.median`` (method "midpoint") computes it."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _quantile_init(x_sorted: torch.Tensor, k_max: int,
                   k_valid: torch.Tensor) -> torch.Tensor:
    """Centroid init at mid-quantiles of sorted (B, n) data; slots at or
    past ``k_valid`` (B,) hold +inf.  The position arithmetic is f32, as in
    the reference."""
    n = x_sorted.shape[-1]
    slot = torch.arange(k_max, device=x_sorted.device)
    kv = k_valid[:, None]
    pos = (slot.float() + 0.5) / torch.clamp(kv, min=1).float()
    idx = torch.clamp((pos * n).to(torch.int32), 0, n - 1).long()
    c = torch.gather(x_sorted, 1, idx)
    return torch.where(slot < kv, c, torch.inf)


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment, x (..., n) against centroids (..., k)
    -> (..., n) int64; +inf centroids are never selected."""
    d = (x[..., :, None] - centroids[..., None, :]).abs()
    d = torch.nan_to_num(d, nan=torch.inf, posinf=torch.inf)  # inf - inf
    return torch.argmin(d, dim=-1)


def kmeans_batch(x: torch.Tensor, k_max: int,
                 k_valid: Optional[IntOrTensor] = None, iters: int = 10,
                 weight: Optional[torch.Tensor] = None, group=None):
    """K-Means on each row of x (B, n) independently.

    k_valid: int or (B,) active centroids per row (None = k_max);
    weight: (B, n), 0 excludes an element.  Returns (centroids (B, k_max),
    ascending over valid slots, +inf in invalid ones; codes (B, n) int64).
    ``group``: each row is this rank's block of a longer one split over a
    ``torch.distributed`` process group, and the Lloyd statistics (per
    cluster sums and counts) are summed over the group (``all_reduce``)
    — the distributed quantizer's form; the init is the local block's.
    """
    x = x.float()
    B, n = x.shape
    dev = x.device
    if k_valid is None:
        k_valid = k_max
    k_valid = torch.as_tensor(k_valid, dtype=torch.int32,
                              device=dev).expand(B)
    w = (torch.ones_like(x) if weight is None else weight.float())

    # init from quantiles of the included values: excluded elements sit at
    # the median so they don't stretch the init range
    x_incl = torch.where(w > 0, x, _median(x)[:, None])
    c = _quantile_init(torch.sort(x_incl, dim=-1).values, k_max, k_valid)
    slot = torch.arange(k_max, device=dev)
    invalid = slot[None, :] >= k_valid[:, None]
    for _ in range(iters):
        a = _assign(x, c)
        onehot = (a[..., None] == slot).float() * w[..., None]  # (B, n, k)
        sums = torch.einsum("bnk,bn->bk", onehot, x)
        counts = onehot.sum(dim=1)
        if group is not None:
            stats = torch.stack([sums, counts])
            dist.all_reduce(stats, group=group)
            sums, counts = stats[0], stats[1]
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1e-9), c)
        c = c.masked_fill(invalid, torch.inf)
    c = torch.sort(c, dim=-1).values
    return c, _assign(x, c)


def kmeans_1d(x: torch.Tensor, k_max: int,
              k_valid: Optional[IntOrTensor] = None, iters: int = 10,
              weight: Optional[torch.Tensor] = None, group=None):
    """1-D K-Means of one column x (n,) (``group``: x is this rank's block
    of a column, statistics summed over the group).  Returns (centroids
    (k_max,), sorted over valid slots, +inf in invalid ones; codes (n,)
    int64)."""
    c, codes = kmeans_batch(x[None], k_max, k_valid, iters,
                            None if weight is None else weight[None], group)
    return c[0], codes[0]


def kmeans_columns(W: torch.Tensor, k_max: int,
                   k_valid: Optional[IntOrTensor] = None, iters: int = 10,
                   weight: Optional[torch.Tensor] = None):
    """Per-column K-Means over (rows, cols); ``k_valid`` scalar or (cols,).
    Returns (codebooks (cols, k_max), codes (rows, cols))."""
    cb, codes = kmeans_batch(W.T, k_max, k_valid, iters,
                             None if weight is None else weight.T)
    return cb, codes.T


def dequantize_codes(codebooks: torch.Tensor,
                     codes: torch.Tensor) -> torch.Tensor:
    """codes (rows, cols) + codebooks (cols, k) -> values (rows, cols)."""
    safe = torch.where(torch.isfinite(codebooks), codebooks, 0.0)
    return torch.gather(safe.T, 0, codes.long())


def inertia(x: torch.Tensor, centroids: torch.Tensor,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted within-cluster sum of squares."""
    codes = _assign(x, centroids)
    safe = torch.where(torch.isfinite(centroids), centroids, 0.0)
    err = x - safe[codes]
    w = torch.ones_like(x) if weight is None else weight
    return torch.sum(w * err * err)
