"""DeepSeek-V2 236B: 60L d=5120, MLA (q_lora=1536, kv_lora=512, rope=64,
128 heads x 128), MoE 2 shared + 160 routed experts (d_ff=1536) top-6,
vocab=102400 [arXiv:2405.04434].  Simplification: all layers MoE (the
published model keeps layer 0 dense); noted in DESIGN.md §8."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288, vocab=102400,
        use_mla=True, q_lora=1536, kv_lora=512, rope_head_dim=64,
        v_head_dim=128,
        n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
        rope_theta=1e4,
    )
