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
W.  On the card the column loop of a block (K-Means, live codebooks,
whole rows) is one CUDA graph, replayed for every block
(``_BlockGraph``).

Row-sharded (``group``, a ``torch.distributed`` process group over which
W's rows are split): each column is gathered whole before its codebook
fit, so every rank fits the identical codebook, while the O(rows * cols)
compensation updates stay on each rank's rows.  The lazy update of a
block is applied as one rank-1 update a column (the reference: one
GEMM), so a row's arithmetic does not depend on the number of rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def _gather_column(w: torch.Tensor, weight: torch.Tensor, group):
    """One column and its weights, gathered whole from every rank's rows
    (one all-gather of the two stacked), in rank order."""
    from repro_torch.dist import collectives
    both = torch.stack([w, weight]).contiguous()
    parts = dist.get_world_size(group)
    out = torch.empty((parts,) + both.shape, dtype=both.dtype,
                      device=both.device)
    collectives.gather_into(out, both, group)
    full = out.permute(1, 0, 2).reshape(2, -1)
    return full[0], full[1]


def _quantize_block(Wb, Ub, kvs, weights, reserved, Qb, Eb, codes_b, cb_b,
                    *, k_max, method, kmeans_iters, codebook_mode,
                    frozen_b=None, group=None):
    """The columns of one block in order: each column's codebook and codes,
    its error, and the eager compensation of the block's later columns
    (``Wb`` updated in place).  ``kvs[i]``: column i's valid centroids (an
    int, or a 0-d device tensor for the K-Means fit); the results go into
    ``Qb``, ``Eb`` (rows, B), ``codes_b`` (rows, B) and ``cb_b`` (B,
    k_max)."""
    for i in range(Wb.shape[1]):
        w = Wb[:, i]
        kv = kvs[i]
        weight = weights[:, i]
        if codebook_mode == "frozen":
            cb = frozen_b[i]
            codes = kmeans_lib._assign(w, cb)
        elif group is not None:
            wf, weight_f = _gather_column(w, weight, group)
            if method == "kmeans":
                cb, _ = kmeans_lib.kmeans_1d(wf, k_max, kv, kmeans_iters,
                                             weight_f)
            else:
                cb = _uniform_codebook(wf, k_max, kv, weight_f)
            codes = kmeans_lib._assign(w, cb)
        elif method == "kmeans":
            cb, codes = kmeans_lib.kmeans_1d(w, k_max, kv, kmeans_iters,
                                             weight)
        else:
            cb = _uniform_codebook(w, k_max, kv, weight)
            codes = kmeans_lib._assign(w, cb)
        safe = torch.where(torch.isfinite(cb), cb, 0.0)
        q = torch.where(reserved[:, i], w, safe[codes])
        err = (w - q) / torch.clamp(Ub[i, i], min=1e-12)
        # columns <= i get no update (the reference masks them to 0)
        Wb[:, i + 1:] -= torch.outer(err, Ub[i, i + 1:])
        Qb[:, i] = q
        Eb[:, i] = err
        codes_b[:, i] = codes.to(torch.int32)
        cb_b[i] = cb


class _BlockGraph:
    """``_quantize_block`` for K-Means with live codebooks on whole rows,
    captured once as a CUDA graph over fixed buffers and replayed for
    every block of the matrix.  A column launches some 140 small kernels;
    run eagerly, the card waits on the host to launch them.  The graph
    replays the same kernels on the same shapes, so its results are the
    eager loop's bit for bit."""

    def __init__(self, rows, blocksize, k_max, kmeans_iters, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.W = torch.zeros((rows, blocksize), **f32)
        self.U = torch.zeros((blocksize, blocksize), **f32)
        self.kv = torch.ones((blocksize,), dtype=torch.int32, device=device)
        self.weight = torch.zeros((rows, blocksize), **f32)
        self.reserved = torch.zeros((rows, blocksize), dtype=torch.bool,
                                    device=device)
        self.Q = torch.zeros((rows, blocksize), **f32)
        self.E = torch.zeros((rows, blocksize), **f32)
        self.codes = torch.zeros((rows, blocksize), dtype=torch.int32,
                                 device=device)
        self.cb = torch.zeros((blocksize, k_max), **f32)
        self.kw = dict(k_max=k_max, method="kmeans",
                       kmeans_iters=kmeans_iters, codebook_mode="live")
        self.graph = None

    def _body(self):
        _quantize_block(self.W, self.U, list(self.kv), self.weight,
                        self.reserved, self.Q, self.E, self.codes, self.cb,
                        **self.kw)

    def _load(self, Wb, Ub, kv, weight, reserved):
        for dst, src in ((self.W, Wb), (self.U, Ub), (self.kv, kv),
                         (self.weight, weight), (self.reserved, reserved)):
            dst.copy_(src)

    def run(self, Wb, Ub, kv, weight, reserved):
        """One block: returns (Q, E, codes, codebooks), the fixed buffers
        (valid until the next ``run``)."""
        if self.graph is None:
            # a warm-up run first (lazy library set-up must not happen
            # under capture), on a side stream as capture wants
            self._load(Wb, Ub, kv, weight, reserved)
            side = torch.cuda.Stream(self.W.device)
            side.wait_stream(torch.cuda.current_stream(self.W.device))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(self.W.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self._body()
        self._load(Wb, Ub, kv, weight, reserved)
        self.graph.replay()
        return self.Q, self.E, self.codes, self.cb


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
    group=None,
    cuda_graph: bool = True,
) -> QuantizeResult:
    """Quantize W (rows, cols) column by column with OBS compensation.

    U: upper-triangular preconditioner from ``prepare_hinv_cholesky``.
    column_bits: (cols,) ints (host array or tensor; k_valid = 2**bits).
    reserved_mask: (rows, cols) bool, entries kept at full precision (OR):
    they add no quantization error and are excluded from codebook fits.
    codebook_mode: 'live' refits each column's codebook on the compensated
    column; 'frozen' uses ``frozen_codebooks`` fitted on the original
    weights.  ``group``: W is this rank's block of rows of a matrix split
    over the group (see the module docstring); the result is the block's.
    ``cuda_graph``: on the card, run K-Means with live codebooks on whole
    rows through ``_BlockGraph`` (the same bits, without the host's launch
    time); False runs the loop eagerly.
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

    graphed = (W.is_cuda and cuda_graph and method == "kmeans"
               and codebook_mode == "live" and group is None)
    block = kv_all = None
    if graphed:
        block = _BlockGraph(rows, blocksize, k_max, kmeans_iters, dev)
        kv_all = torch.as_tensor(1 << bits, dtype=torch.int32, device=dev)
    for j0 in range(0, cols, blocksize):
        j1 = j0 + blocksize
        Ub = U[j0:j1, j0:j1]
        if block is not None:
            Qb, Eb, codes_b, cb_b = block.run(
                W[:, j0:j1], Ub, kv_all[j0:j1], weight_all[:, j0:j1],
                reserved_mask[:, j0:j1])
            codes_all[:, j0:j1] = codes_b
            cb_all[j0:j1] = cb_b
        else:
            Wb = W[:, j0:j1].clone()
            Qb = torch.zeros_like(Wb)
            Eb = torch.zeros_like(Wb)
            _quantize_block(
                Wb, Ub, [1 << int(b) for b in bits[j0:j1]],
                weight_all[:, j0:j1], reserved_mask[:, j0:j1], Qb, Eb,
                codes_all[:, j0:j1], cb_all[j0:j1], k_max=k_max,
                method=method, kmeans_iters=kmeans_iters,
                codebook_mode=codebook_mode,
                frozen_b=(frozen_codebooks[j0:j1]
                          if codebook_mode == "frozen" else None),
                group=group)
        # lazy update of all later columns: one rank-1 update a column
        # of the block, in column order, so every element's sum is taken
        # in the same order however many rows W holds (a row-sharded
        # run is then bitwise the whole matrix's, on the card too, where
        # a GEMM's kernel and summation order follow its row count)
        rest = W[:, j1:]
        for i in range(blocksize):
            rest.addr_(Eb[:, i], U[j0 + i, j1:], alpha=-1)
        W[:, j0:j1] = Qb
    return QuantizeResult(Q=W, codes=codes_all, codebooks=cb_all,
                          reserved=reserved_mask)
