"""Zamba2-1.2B: 38 Mamba2 layers (d=2048, state=64) + a shared transformer
block (attn+MLP d_ff=8192, per-site LoRA) applied every 6 layers
[arXiv:2411.15242].  attn_window=4096 makes the shared block sub-quadratic
at 500k context (see DESIGN.md §8)."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_1p2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=64,
        attn_every=6, attn_window=4096, rope_theta=1e4,
    )
