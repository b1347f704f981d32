"""Granite-8B (code): llama-arch 36L d=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 [arXiv:2405.04324]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=49152, rope_theta=1e4, tie_embeddings=True,
        mlp_type="swiglu",
    )
