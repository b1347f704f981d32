"""CLAQ orchestration: plan -> quantize -> package, per matrix and per
model (port of ``repro.core.claq``).  The row-sharded variant
(``quantize_matrix(..., mesh=, shard_axis=)``) splits the matrix rows
over one dim of a ``DeviceMesh`` for mesh-parallel quantization of large
matrices: each rank runs the GPTQ loop on its rows, fitting each
column's codebook on the column gathered whole (so every rank fits the
identical codebook), and the blocks are gathered back.

Everything runs on the device of the weight it is given: the card for the
launchers (``launch/quantize.py``), the CPU in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.context import mesh_shape

from . import gptq, kmeans as kmeans_lib, outlier as outlier_lib, policy
from .policy import APConfig, CLAQConfig, ORConfig  # re-export  # noqa: F401
from .quantized import QuantizedTensor, build_quantized_tensor


@dataclasses.dataclass(frozen=True)
class MatrixPlan:
    """Host-side allocation decisions for one matrix."""
    column_bits: np.ndarray      # (cols,) int
    reserve_counts: np.ndarray   # (cols,) int
    achieved_code_bits: float
    achieved_extra_bits: float
    outlier_ratio: np.ndarray    # (cols,) float — the Outlier Order metric


@dataclasses.dataclass(frozen=True)
class QuantStats:
    proxy_loss: float          # tr((W-Q) H (W-Q)^T) / rows
    mse: float
    effective_bits: float      # codes + reserved outliers
    effective_bits_with_codebooks: float
    code_bits: float
    extra_bits: float


def plan_matrix(W: torch.Tensor, cfg: CLAQConfig,
                metric: str = "outlier_order",
                act_norm: Optional[torch.Tensor] = None) -> MatrixPlan:
    """Per-column bit-widths and reservation counts.  metric:
    'outlier_order' (paper) or 'magnitude_mp' (Table 3 baseline)."""
    rows, cols = W.shape
    if metric == "outlier_order":
        R = outlier_lib.outlier_ratio(W, cfg.outlier_standard)
        # Tie-break by normalized column peak magnitude: R_j moves in steps
        # of 1/rows, so a term < 1/(2*rows) never reorders distinct ratios,
        # but it keeps an Outlier Order when no entry clears S*mean.
        peak = W.float().abs().amax(dim=0)
        R = R + peak / (peak.max() + 1e-30) * (0.5 / rows)
    elif metric == "magnitude_mp":
        R = policy.magnitude_mp_metric(W, act_norm)
    else:
        raise ValueError(metric)

    if cfg.ap is not None:
        bits, code_bits = policy.ap_column_bits(R, cfg.ap)
    else:
        bits = torch.full((cols,), cfg.bits, dtype=torch.int32)
        code_bits = float(cfg.bits)

    if cfg.orr is not None:
        counts, extra_bits = policy.or_reserve_counts(R, rows, cfg.orr)
    else:
        counts = torch.zeros((cols,), dtype=torch.int32)
        extra_bits = 0.0

    return MatrixPlan(
        column_bits=bits.cpu().numpy(),
        reserve_counts=counts.cpu().numpy(),
        achieved_code_bits=float(code_bits),
        achieved_extra_bits=float(extra_bits),
        outlier_ratio=R.cpu().numpy(),
    )


def _pad_cols(t: torch.Tensor, cols_p: int, value=0) -> torch.Tensor:
    pad = cols_p - t.shape[-1]
    if pad == 0:
        return t
    return torch.nn.functional.pad(t, (0, pad), value=value)


def quantize_matrix(
    W: torch.Tensor,
    H: Optional[torch.Tensor],
    cfg: CLAQConfig,
    plan: Optional[MatrixPlan] = None,
    mesh=None,
    shard_axis: str = "model",
) -> Tuple[QuantizedTensor, torch.Tensor, QuantStats]:
    """Quantize one (rows = out, cols = in) matrix with the full CLAQ
    recipe, on W's device.  H=None means an identity Hessian (weight-space
    rounding).  ``mesh``: every rank passes the whole W and H, and the
    GPTQ loop runs row-sharded over mesh dim ``shard_axis`` (rows must
    divide).  Returns (QuantizedTensor, dequantized matrix, stats)."""
    W = W.float()
    dev = W.device
    rows, cols = W.shape
    if plan is None:
        plan = plan_matrix(W, cfg, metric=cfg.metric)
    if H is None:
        H = torch.eye(cols, device=dev)
    H = H.to(dev).float()

    reserved = outlier_lib.topk_per_column_mask(
        W, torch.as_tensor(plan.reserve_counts, device=dev))

    # pad the column axis to the GPTQ blocksize (identity-extended Hessian)
    B = cfg.gptq_blocksize
    cols_p = -(-cols // B) * B
    Wp = _pad_cols(W, cols_p)
    Hp = torch.eye(cols_p, device=dev)
    Hp[:cols, :cols] = H
    bits_p = np.full(cols_p, int(plan.column_bits.min(initial=cfg.bits)))
    bits_p[:cols] = plan.column_bits
    res_p = _pad_cols(reserved, cols_p, value=False)

    U = gptq.prepare_hinv_cholesky(Hp, cfg.percdamp)

    frozen = None
    if cfg.codebook_mode == "frozen":
        frozen, _ = kmeans_lib.kmeans_columns(
            Wp, k_max=2 ** cfg.p_max,
            k_valid=torch.as_tensor(2 ** bits_p, device=dev),
            iters=cfg.kmeans_iters, weight=(~res_p).float())

    kwargs = dict(k_max=2 ** cfg.p_max, blocksize=B, method=cfg.method,
                  kmeans_iters=cfg.kmeans_iters,
                  codebook_mode=cfg.codebook_mode, frozen_codebooks=frozen)
    if mesh is not None and mesh_shape(mesh).get(shard_axis, 1) > 1:
        result = _quantize_rowsharded(Wp, U, bits_p, res_p, kwargs, mesh,
                                      shard_axis)
    else:
        result = gptq.gptq_quantize_matrix(Wp, U, bits_p, res_p, **kwargs)

    Q = result.Q[:, :cols]
    qt = build_quantized_tensor(
        codes=result.codes[:, :cols], codebooks=result.codebooks[:cols],
        column_bits=plan.column_bits, reserve_counts=plan.reserve_counts,
        Q=Q, reserved_mask=reserved)
    stats = QuantStats(
        proxy_loss=float(gptq.proxy_loss(W, Q, H)),
        mse=float(torch.mean((W - Q) ** 2)),
        effective_bits=qt.effective_bits(),
        effective_bits_with_codebooks=qt.effective_bits(
            include_codebooks=True),
        code_bits=plan.achieved_code_bits,
        extra_bits=plan.achieved_extra_bits,
    )
    return qt, Q, stats


def _quantize_rowsharded(Wp, U, bits_p, res_p, kwargs, mesh, shard_axis):
    """The GPTQ loop with Wp's rows split over ``shard_axis``: each rank
    quantizes its block, the codebooks come out identical on every rank,
    and Q and the codes are gathered back whole (the reserved mask is
    every rank's already)."""
    from repro_torch.dist import collectives
    pg = collectives.group(mesh, shard_axis)
    parts = collectives.axis_size(mesh, shard_axis)
    index = collectives.coordinate(mesh, shard_axis)
    rows = Wp.shape[0]
    if rows % parts:
        raise ValueError(f"{rows} rows do not split over {shard_axis}="
                         f"{parts}")
    sl = collectives.shard_slice(rows, parts, index)
    res = gptq.gptq_quantize_matrix(Wp[sl].contiguous(), U, bits_p,
                                    res_p[sl].contiguous(), group=pg,
                                    **kwargs)

    def whole(t):
        out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        collectives.gather_into(out, t.contiguous(), pg)
        return out
    return gptq.QuantizeResult(Q=whole(res.Q), codes=whole(res.codes),
                               codebooks=res.codebooks,
                               reserved=res_p)


# ---------------------------------------------------------------------------
# Whole-model quantization
# ---------------------------------------------------------------------------

def default_quantize_predicate(path: str, leaf: Any) -> bool:
    """Quantize 2-D matmul weights; leave embeddings, norms, biases and
    tiny recurrence parameters in fp."""
    if not hasattr(leaf, "ndim") or leaf.ndim != 2:
        return False
    name = path.lower()
    if any(k in name for k in ("embed", "norm", "bias", "a_log", "dt_bias",
                               "decay", "conv", "pos", "router")):
        return False
    return min(leaf.shape) >= 32


def quantize_model(
    params: Dict[str, Any],
    hessians: Dict[str, torch.Tensor],
    cfg: CLAQConfig,
    predicate: Callable[[str, Any], bool] = default_quantize_predicate,
    dense_output: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, QuantStats]]:
    """Quantize every eligible kernel of a flat ``{name: tensor}`` dict.

    Kernels are in (in, out) layout; the engine works in paper layout
    (out, in), so they are transposed on the way in and out.  ``hessians``
    maps names to (in, in) Hessians; missing ones fall back to identity.
    Returns (new dict with QuantizedTensor (or dense) values, stats)."""
    out: Dict[str, Any] = {}
    stats: Dict[str, QuantStats] = {}
    for name, leaf in params.items():
        if not predicate(name, leaf):
            out[name] = leaf
            continue
        qt, Q, st = quantize_matrix(leaf.float().T, hessians.get(name), cfg)
        stats[name] = st
        out[name] = Q.T.to(leaf.dtype) if dense_output else qt
    return out, stats
