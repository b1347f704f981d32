"""Phi-3-Vision 4.2B: phi3-mini backbone 32L d=3072 32H (kv=32) d_ff=8192
vocab=32064 + CLIP frontend (stubbed: precomputed patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3_vision_4p2b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab=32064, rope_theta=1e4, mlp_type="swiglu",
        modality="vision", prefix_frac=0.25,
    )
