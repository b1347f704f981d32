"""RWKV6-7B ("Finch"): attention-free, 32L d=4096 d_ff=14336 vocab=65536,
data-dependent per-channel decay [arXiv:2404.05892]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_7b", family="rwkv",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536, rwkv_head_dim=64, decay_lora=64,
        rwkv_chunk=64,
    )
