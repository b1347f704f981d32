"""Blocked GPTQ (OBS-style) quantize-and-compensate engine with pluggable
column quantizers (K-Means / uniform), per-column bit-widths (Adaptive
Precision) and per-column fp outlier reservation (OR) (port of
``repro.core.gptq``).

W has shape (rows = out_features, cols = in_features); the Hessian
H = X^T X is (cols, cols) over input features, and columns are quantized
in order with lazy blocked error compensation, as in GPTQ:

    U = cholesky(inv(H + damp*I), upper)
    for each column j (in blocks of `blocksize`):
        q_j   = Quant(w_j)                # K-Means / uniform, bits_j levels
        err_j = (w_j - q_j) / U[j, j]
        W[:, j+1:] -= err_j  U[j, j+1:]   # within block eagerly, rest lazily

The reference's two ``fori_loop``s are Python loops here, over blocks and
over the columns of a block; every per-column step stays on the device of
W (no host synchronisation inside the loop).  The row-sharded variant
(``axis_name``) waits for the port's distribution slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import kmeans as kmeans_lib


# ---------------------------------------------------------------------------
# Hessian plumbing
# ---------------------------------------------------------------------------

class HessianState(NamedTuple):
    H: torch.Tensor        # (in_dim, in_dim) running sum of 2 * x x^T
    count: int             # tokens accumulated


def init_hessian(in_dim: int, dtype=torch.float32,
                 device=None) -> HessianState:
    return HessianState(torch.zeros((in_dim, in_dim), dtype=dtype,
                                    device=device), 0)


def accumulate_hessian(state: HessianState, x: torch.Tensor) -> HessianState:
    """x: (..., in_dim) calibration activations feeding this matrix."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    return HessianState(state.H + 2.0 * (x2.T @ x2),
                        state.count + x2.shape[0])


def finalize_hessian(state: HessianState) -> torch.Tensor:
    return state.H / float(max(state.count, 1))


def prepare_hinv_cholesky(H: torch.Tensor,
                          percdamp: float = 0.01) -> torch.Tensor:
    """GPTQ's preconditioner U = cholesky(inv(H_damped), upper).  Dead
    input dims (zero diagonal) get a diagonal of 1 (their weights are then
    quantized without compensation, as in reference GPTQ)."""
    d = torch.diagonal(H)
    dead = d <= 0.0
    H = H + torch.diag(dead.to(H.dtype))
    damp = percdamp * torch.mean(torch.where(dead, 0.0, d))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L = torch.linalg.cholesky(H + damp * eye)
    Hinv = torch.cholesky_solve(eye, L)
    Hinv = (Hinv + Hinv.T) * 0.5
    # upper factor: Hinv = U^T U with U = L^T (L the lower factor)
    return torch.linalg.cholesky(Hinv).T


def proxy_loss(W: torch.Tensor, Q: torch.Tensor,
               H: torch.Tensor) -> torch.Tensor:
    """Calibration-set objective tr((W-Q) H (W-Q)^T) / rows."""
    D = (W - Q).float()
    return torch.sum((D @ H.float()) * D) / W.shape[0]


# ---------------------------------------------------------------------------
# Column quantizers
# ---------------------------------------------------------------------------

def _uniform_codebook(w: torch.Tensor, k_max: int, k_valid: int,
                      weight: torch.Tensor) -> torch.Tensor:
    """Asymmetric min-max uniform grid over the non-reserved entries
    (GPTQ's per-column asymmetric quantizer, as a codebook)."""
    big = 3.4e38
    lo = torch.min(torch.where(weight > 0, w, big))
    hi = torch.max(torch.where(weight > 0, w, -big))
    lo = torch.minimum(lo, hi)          # a fully reserved column
    slot = torch.arange(k_max, dtype=torch.float32, device=w.device)
    cb = lo + (hi - lo) * slot / float(max(k_valid - 1, 1))
    return torch.where(slot < k_valid, cb, torch.inf)


class QuantizeResult(NamedTuple):
    Q: torch.Tensor           # (rows, cols) dequantized (reserved at fp)
    codes: torch.Tensor       # (rows, cols) int32 centroid indices
    codebooks: torch.Tensor   # (cols, k_max) f32, +inf in invalid slots
    reserved: torch.Tensor    # (rows, cols) bool


def gptq_quantize_matrix(
    W: torch.Tensor,
    U: torch.Tensor,
    column_bits,
    reserved_mask: torch.Tensor,
    *,
    k_max: int,
    blocksize: int = 128,
    method: str = "kmeans",
    kmeans_iters: int = 10,
    codebook_mode: str = "live",
    frozen_codebooks: Optional[torch.Tensor] = None,
) -> QuantizeResult:
    """Quantize W (rows, cols) column by column with OBS compensation.

    U: upper-triangular preconditioner from ``prepare_hinv_cholesky``.
    column_bits: (cols,) ints (host array or tensor; k_valid = 2**bits).
    reserved_mask: (rows, cols) bool, entries kept at full precision (OR):
    they add no quantization error and are excluded from codebook fits.
    codebook_mode: 'live' refits each column's codebook on the compensated
    column; 'frozen' uses ``frozen_codebooks`` fitted on the original
    weights.
    """
    rows, cols = W.shape
    if cols % blocksize:
        raise ValueError("pad columns to a multiple of blocksize")
    if method not in ("kmeans", "uniform"):
        raise ValueError(f"unknown method {method!r}")
    dev = W.device
    W = W.float().clone()
    U = U.float()
    bits = np.asarray(torch.as_tensor(column_bits).cpu()).astype(np.int64)
    reserved_mask = reserved_mask.to(dev)
    weight_all = (~reserved_mask).float()
    if codebook_mode == "frozen" and frozen_codebooks is None:
        frozen_codebooks = torch.full((cols, k_max), torch.inf, device=dev)
    codes_all = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    cb_all = torch.full((cols, k_max), torch.inf, device=dev)

    for j0 in range(0, cols, blocksize):
        j1 = j0 + blocksize
        Wb = W[:, j0:j1].clone()
        Ub = U[j0:j1, j0:j1]
        Qb = torch.zeros_like(Wb)
        Eb = torch.zeros_like(Wb)
        for i in range(blocksize):
            j = j0 + i
            w = Wb[:, i]
            kv = 1 << int(bits[j])
            weight = weight_all[:, j]
            if codebook_mode == "frozen":
                cb = frozen_codebooks[j]
                codes = kmeans_lib._assign(w, cb)
            elif method == "kmeans":
                cb, codes = kmeans_lib.kmeans_1d(w, k_max, kv, kmeans_iters,
                                                 weight)
            else:
                cb = _uniform_codebook(w, k_max, kv, weight)
                codes = kmeans_lib._assign(w, cb)
            safe = torch.where(torch.isfinite(cb), cb, 0.0)
            q = torch.where(reserved_mask[:, j], w, safe[codes])
            err = (w - q) / torch.clamp(Ub[i, i], min=1e-12)
            # columns <= i get no update (the reference masks them to 0)
            Wb[:, i + 1:] -= torch.outer(err, Ub[i, i + 1:])
            Qb[:, i] = q
            Eb[:, i] = err
            codes_all[:, j] = codes.to(torch.int32)
            cb_all[j] = cb
        # lazy update of all later columns
        W[:, j1:] -= Eb @ U[j0:j1, j1:]
        W[:, j0:j1] = Qb
    return QuantizeResult(Q=W, codes=codes_all, codebooks=cb_all,
                          reserved=reserved_mask)
