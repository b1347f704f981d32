"""LLaMA-1 7B — the paper's own evaluation model [arXiv:2302.13971]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama1_7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=32000, rope_theta=1e4, mlp_type="swiglu",
    )
