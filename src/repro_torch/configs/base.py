"""ModelConfig schema + input-shape cells shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_dim: int = 0            # 0 -> full head_dim
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_window: Optional[int] = None
    mlp_type: str = "swiglu"       # swiglu | gelu

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1            # dispatch groups (launcher sets = DP shards)

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn every N ssm layers

    # --- RWKV6 -----------------------------------------------------------------
    rwkv_head_dim: int = 64
    decay_lora: int = 64
    rwkv_chunk: int = 64

    # --- enc-dec -----------------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality stub (vlm / audio) -----------------------------------------------
    modality: str = "text"         # text | vision | audio
    prefix_frac: float = 0.25      # fraction of seq_len taken by the frontend stub

    # --- runtime ------------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    q_block: int = 512
    kv_block: int = 1024

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid-with-window / linear)."""
        return self.family in ("rwkv", "hybrid")

    @property
    def n_sites(self) -> int:
        if self.attn_every <= 0:
            return 0
        return (self.n_layers + self.attn_every - 1) // self.attn_every


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell; else reason for skip."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Scale a config down to a CPU-runnable smoke variant of the same family."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 if cfg.attn_every <= 0 else max(cfg.attn_every, 2)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        rotary_dim=16 if cfg.rotary_dim else 0,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        q_lora=64 if cfg.q_lora else 0,
        kv_lora=32 if cfg.kv_lora else 0,
        rope_head_dim=16 if cfg.rope_head_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=16,
        rwkv_head_dim=16 if cfg.family == "rwkv" else cfg.rwkv_head_dim,
        decay_lora=16 if cfg.family == "rwkv" else cfg.decay_lora,
        rwkv_chunk=8,
        enc_layers=min(cfg.enc_layers, 2),
        dec_layers=min(cfg.dec_layers, 2),
        attn_every=2 if cfg.attn_every else 0,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else None,
        dtype="float32",
        q_block=64,
        kv_block=64,
    )
