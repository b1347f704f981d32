"""The yardstick's arithmetic: the card's peaks, K1's least bytes and
operations (copied from ``chip_smoke.chain_bytes_flops`` / ``bound_of``),
and the model FLOPs of served tokens."""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def chain_bytes_flops(pqt, m: int, x_itemsize: int) -> Tuple[int, int]:
    """Least bytes and FLOPs of one prepared matmul at M = ``m``: every plan
    operand and x read once, the f32 y written once; 2 M N K operations."""
    n_bytes = m * pqt.cols * x_itemsize + m * pqt.n_padded * 4
    for g in pqt.groups:
        for t in (*g.planes, g.codebook, g.out_idx, g.out_val, g.x_idx):
            if t is not None:
                n_bytes += t.numel() * t.element_size()
    return n_bytes, 2 * m * pqt.rows * pqt.cols


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def _per_token(m: dict) -> Tuple[float, float]:
    """(FLOPs of one token through the blocks apart from attention over
    its context, FLOPs per key of context): 2 x the weights it touches
    (only its top-k experts, and the router), and QK^T and PV."""
    D, H, KH, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = D * (H + 2 * KH) * hd + H * hd * D
    if m["family"] == "moe":
        mlp = m["top_k"] * 3 * D * m["d_ff_expert"] + D * m["n_experts"]
    else:
        mlp = 3 * D * m["d_ff"]
    L = m["n_layers"]
    return L * 2.0 * (attn + mlp), L * 4.0 * H * hd


def head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab"]


def prefill_flops(m: dict, prompt: int) -> float:
    """A prompt's FLOPs: position c over its c + 1 causal keys, the head
    once (the logits of the last position)."""
    base, per_key = _per_token(m)
    return (prompt * base + per_key * prompt * (prompt + 1) / 2
            + head_flops(m))


def decode_flops(m: dict, context: int) -> float:
    """One decode token over ``context`` keys (its own included)."""
    base, per_key = _per_token(m)
    return base + per_key * context + head_flops(m)
