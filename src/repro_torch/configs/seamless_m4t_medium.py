"""SeamlessM4T-medium backbone: enc-dec, 12L encoder + 12L decoder,
d=1024 16H (kv=16) d_ff=4096 vocab=256206; speech frontend stubbed as
precomputed frame embeddings [arXiv:2308.11596].

vocab is padded 256206 -> 256224 (multiple of 32) so the vocab axis is
TP-shardable on the production mesh - standard framework practice; the 18
pad tokens are never emitted by the data pipeline."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_medium", family="encdec",
        n_layers=24, enc_layers=12, dec_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256224, rope_theta=1e4, mlp_type="gelu",
        modality="audio",
    )
