"""Round-To-Nearest baselines, no GPTQ error compensation (port of
``repro.core.rtn``).

Two codebook flavours so the paper's ablation axes separate cleanly:
  * 'uniform' — per-column asymmetric min-max grid (the classic RTN
                baseline of Table 1);
  * 'kmeans'  — CLAQ's codebooks *without* compensation (isolates the
                value of K-Means centroids from the value of OBS updates).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kmeans as kmeans_lib


def rtn_quantize_matrix(W: torch.Tensor, bits: int, method: str = "uniform",
                        kmeans_iters: int = 10,
                        reserved_mask: Optional[torch.Tensor] = None):
    """Quantize all columns of W (rows, cols) independently; elements under
    ``reserved_mask`` are excluded from the codebooks and kept exactly.
    Returns (Q (rows, cols) f32, codes (rows, cols) int64, codebooks
    (cols, 2^bits) f32)."""
    W = W.float()
    k = 2 ** bits
    weight = None
    if reserved_mask is not None:
        weight = torch.where(reserved_mask, 0.0, 1.0)

    if method == "kmeans":
        cbs, codes = kmeans_lib.kmeans_columns(W, k_max=k, iters=kmeans_iters,
                                               weight=weight)
    elif method == "uniform":
        if weight is None:
            lo, hi = W.amin(dim=0), W.amax(dim=0)
        else:   # nanmin / nanmax over the kept elements, 0 if none is kept
            keep = weight > 0
            lo = torch.where(keep, W, torch.inf).amin(dim=0)
            hi = torch.where(keep, W, -torch.inf).amax(dim=0)
            lo = torch.where(torch.isfinite(lo), lo, 0.0)
            hi = torch.where(torch.isfinite(hi), hi, 0.0)
        steps = torch.arange(k, dtype=torch.float32, device=W.device)
        cbs = lo[:, None] + (hi - lo)[:, None] * (steps[None, :]
                                                  / max(k - 1, 1))
        codes = kmeans_lib._assign(W.T, cbs).T
    else:
        raise ValueError(method)

    Q = kmeans_lib.dequantize_codes(cbs, codes)
    if reserved_mask is not None:
        Q = torch.where(reserved_mask, W, Q)
    return Q, codes, cbs
