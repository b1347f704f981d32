"""Heuristic adaptive-precision search across matrices (paper Appendix G;
a copy of ``repro.core.search``, which is pure host numpy).

Each matrix may be assigned one of three classes: pure p_lo, a p_lo&3 mix,
or a p_lo&4 mix.  Matrices are ranked by whole-matrix outlier ratio
(HAWQ-v2-flavoured), and we enumerate feasible (class counts, high-precision
column fraction) combinations under the model-size constraint, scoring each
by the paper's precision score:

    PS_total = OR_4 * PS_4 * p_4 * M_4 + OR_3 * PS_3 * p_3 * M_3     (Eq. 7)

The configuration with the maximal score wins.  This module is pure host
Python over per-matrix summary statistics, so it is fast and testable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatrixInfo:
    name: str
    rows: int
    cols: int
    outlier_ratio: float   # whole-matrix (Appendix A)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    # name -> (bit_pair, high_fraction); bit_pair like (2, 4) or (2, 2)=pure
    assignment: Dict[str, Tuple[Tuple[int, int], float]]
    avg_bits: float
    score: float


def heuristic_ap_search(
    matrices: Sequence[MatrixInfo],
    target_bits: float,
    p_lo: int = 2,
    ps3: float = 3.0,
    ps4: float = 4.0,
    fractions: Sequence[float] = (0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.526, 0.6),
) -> SearchResult:
    """Enumerate (M4, M3, p4, p3) splits and pick the max-precision-score one.

    Matrices sorted by outlier ratio; the top M4 get the (p_lo,4) mix at
    fraction p4, the next M3 get (p_lo,3) at fraction p3, the rest pure p_lo.
    Budget: average bits over all elements <= target_bits.
    """
    mats = sorted(matrices, key=lambda m: -m.outlier_ratio)
    sizes = np.array([m.rows * m.cols for m in mats], dtype=np.float64)
    ors = np.array([m.outlier_ratio for m in mats], dtype=np.float64)
    total = sizes.sum()
    n = len(mats)

    # candidate counts: coarse grid to keep enumeration tractable at n~200
    count_grid = sorted({0, 1, 2, 4, 8, 16, 19, 32, 64, n // 4, n // 2, n})
    count_grid = [c for c in count_grid if 0 <= c <= n]

    best: SearchResult | None = None
    for m4 in count_grid:
        for m3 in count_grid:
            if m4 + m3 > n:
                continue
            for p4 in fractions:
                for p3 in fractions:
                    s4 = sizes[:m4]
                    s3 = sizes[m4:m4 + m3]
                    s2 = sizes[m4 + m3:]
                    bits = (np.sum(s4) * (p_lo + p4 * (4 - p_lo))
                            + np.sum(s3) * (p_lo + p3 * (3 - p_lo))
                            + np.sum(s2) * p_lo) / total
                    if bits > target_bits + 1e-9:
                        continue
                    score = (float(np.sum(ors[:m4])) * ps4 * p4 * max(m4, 1)
                             + float(np.sum(ors[m4:m4 + m3])) * ps3 * p3 * max(m3, 1))
                    if best is None or score > best.score:
                        assignment = {}
                        for i, m in enumerate(mats):
                            if i < m4:
                                assignment[m.name] = ((p_lo, 4), p4)
                            elif i < m4 + m3:
                                assignment[m.name] = ((p_lo, 3), p3)
                            else:
                                assignment[m.name] = ((p_lo, p_lo), 0.0)
                        best = SearchResult(assignment=assignment,
                                            avg_bits=float(bits), score=float(score))
    assert best is not None
    return best


def assignment_to_claq_configs(result: SearchResult, base_cfg) -> Dict[str, object]:
    """Materialize per-matrix CLAQConfig objects from a search result."""
    from .policy import APConfig, CLAQConfig
    out = {}
    for name, ((lo, hi), frac) in result.assignment.items():
        if hi == lo or frac == 0.0:
            cfg = dataclasses.replace(base_cfg, bits=lo, ap=None)
        else:
            target = lo + frac * (hi - lo)
            cfg = dataclasses.replace(
                base_cfg, bits=lo,
                ap=APConfig(target_bits=target, p_lo=lo, p_hi=hi))
        out[name] = cfg
    return out
