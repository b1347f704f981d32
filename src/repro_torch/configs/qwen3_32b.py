"""Qwen3-32B: 64L d=5120 64H (GQA kv=8) d_ff=25600 vocab=151936; qk-norm
[hf:Qwen/Qwen3-8B family]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
        mlp_type="swiglu",
    )
