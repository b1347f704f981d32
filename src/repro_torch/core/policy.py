"""Bit-budget policies: Adaptive Precision (§3.3) and Outlier Reservation
(§3.4) (port of ``repro.core.policy``).

Both are driven by the Outlier Order metric (outlier.py).  The policies are
pure functions from (R, budget) -> per-column allocations; the budget
arithmetic is plain Python, so counts equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import outlier as outlier_lib

# Storage cost of one reserved fp16 outlier: 16-bit value + 16-bit row index.
BITS_PER_RESERVED_OUTLIER = 32.0


@dataclasses.dataclass(frozen=True)
class APConfig:
    """Two-level Adaptive Precision (the paper keeps |B| = 2)."""
    target_bits: float
    p_lo: int = 2
    p_hi: int = 4


@dataclasses.dataclass(frozen=True)
class ORConfig:
    """Column-level adaptive outlier reservation.  ``extra_bits`` is the
    budget in average bits per element; ``o1``/``o2`` split the outlier
    count between the top ``top_frac`` sensitive columns and the rest
    (paper Appendix C, Setting 2: 28 % / 72 %)."""
    extra_bits: float
    o1: float = 0.28
    o2: float = 0.72
    top_frac: float = 0.10


@dataclasses.dataclass(frozen=True)
class CLAQConfig:
    """Full per-matrix quantization recipe.

    method: 'kmeans' (paper) or 'uniform' (GPTQ-style min-max grid).
    codebook_mode: 'live' re-clusters each column on the GPTQ-compensated
    values (paper-faithful); 'frozen' fits codebooks once on the original
    weights.  metric: 'outlier_order' (paper) or 'magnitude_mp' (Table 3's
    MP-dagger baseline).
    """
    bits: int = 4
    method: str = "kmeans"
    ap: Optional[APConfig] = None
    orr: Optional[ORConfig] = None
    outlier_standard: float = outlier_lib.DEFAULT_OUTLIER_STANDARD
    kmeans_iters: int = 10
    gptq_blocksize: int = 128
    percdamp: float = 0.01
    codebook_mode: str = "live"
    metric: str = "outlier_order"

    @property
    def p_max(self) -> int:
        return self.ap.p_hi if self.ap is not None else self.bits


def draft_config(qcfg: CLAQConfig, draft_bits: int) -> CLAQConfig:
    """The low-bit draft recipe for self-speculative decoding: the same
    engine knobs, a flat ``draft_bits`` code width (AP dropped), Outlier
    Reservation kept."""
    if draft_bits < 1:
        raise ValueError(f"draft_bits must be >= 1, got {draft_bits}")
    return dataclasses.replace(qcfg, bits=draft_bits, ap=None)


def ap_column_bits(R: torch.Tensor, cfg: APConfig
                   ) -> Tuple[torch.Tensor, float]:
    """Per-column bit-widths for two-level AP: the high-precision column
    count n_hi = round(cols * (target - p_lo) / (p_hi - p_lo)) (Eq. 4).
    Returns (bits (cols,) int32, achieved average bits)."""
    cols = R.shape[0]
    frac = (cfg.target_bits - cfg.p_lo) / (cfg.p_hi - cfg.p_lo)
    if not (0.0 <= frac <= 1.0):
        raise ValueError(
            f"target {cfg.target_bits} outside [{cfg.p_lo}, {cfg.p_hi}]")
    n_hi = int(round(frac * cols))
    hi_mask = outlier_lib.top_fraction_mask(R, n_hi / cols if cols else 0.0)
    bits = torch.where(hi_mask, cfg.p_hi, cfg.p_lo).to(torch.int32)
    achieved = (n_hi * cfg.p_hi + (cols - n_hi) * cfg.p_lo) / max(cols, 1)
    return bits, achieved


def or_reserve_counts(R: torch.Tensor, rows: int, cfg: ORConfig
                      ) -> Tuple[torch.Tensor, float]:
    """Per-column reserved-outlier counts (Eq. 5): N = extra_bits * numel /
    32 outliers, split o1 : o2 between the top ``top_frac`` columns and the
    rest, the same count per column inside each class.  Returns (counts
    (cols,) int32, achieved extra bits per element)."""
    cols = R.shape[0]
    numel = rows * cols
    total = cfg.extra_bits * numel / BITS_PER_RESERVED_OUTLIER
    n_top = max(int(round(cfg.top_frac * cols)), 1)
    n_rest = cols - n_top
    k1 = int(round(cfg.o1 * total / n_top))
    k2 = int(round(cfg.o2 * total / max(n_rest, 1))) if n_rest else 0
    k1 = min(k1, rows)
    k2 = min(k2, rows)
    top = outlier_lib.top_fraction_mask(R, n_top / cols if cols else 0.0)
    counts = torch.where(top, k1, k2).to(torch.int32)
    achieved = ((n_top * k1 + n_rest * k2) * BITS_PER_RESERVED_OUTLIER
                / max(numel, 1))
    return counts, achieved


def magnitude_mp_metric(W: torch.Tensor,
                        act_norm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Baseline mixed-precision metric (Table 3's MP-dagger): mean column
    magnitude, times the activations' per-input L2 norm when given."""
    col_mag = W.float().abs().mean(dim=0)
    if act_norm is None:
        return col_mag
    return col_mag * act_norm.float()


def codebook_overhead_bits(rows: int, bits_per_col: torch.Tensor,
                           k_max: int) -> float:
    """Average per-element overhead of storing per-column codebooks:
    2**bits fp16 entries per column spread over ``rows`` elements
    (``k_max`` is unused, as in the reference)."""
    entries = torch.sum(2.0 ** bits_per_col.float())
    return float(entries * 16.0 / (rows * bits_per_col.shape[0]))


def effective_bits(rows: int, bits_per_col: torch.Tensor,
                   reserve_counts: Optional[torch.Tensor] = None) -> float:
    """Average stored bits per element: codes + reserved outliers (the
    paper's accounting; codebooks reported separately)."""
    cols = bits_per_col.shape[0]
    code_bits = float(torch.sum(bits_per_col)) / cols
    extra = 0.0
    if reserve_counts is not None:
        extra = (float(torch.sum(reserve_counts)) * BITS_PER_RESERVED_OUTLIER
                 / (rows * cols))
    return code_bits + extra
