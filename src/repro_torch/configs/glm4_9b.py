"""GLM-4 9B: 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552; RoPE over
half the head dim, QKV bias [hf:THUDM/glm-4-9b]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4_9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab=151552, qkv_bias=True, rotary_dim=64,
        rope_theta=1e4, mlp_type="swiglu",
    )
