"""Qwen3-30B-A3B: 48L d=2048 32H (GQA kv=4), MoE 128 experts top-8
(d_ff=768), vocab=151936, qk-norm [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_30b_a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
        n_experts=128, n_shared_experts=0, top_k=8, d_ff_expert=768,
    )
