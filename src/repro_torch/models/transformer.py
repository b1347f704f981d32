"""Decoder LM, dense family (port of the dense path of
``repro.models.transformer``).

Blocks live in an ``nn.ModuleList`` and run in a Python loop (the
reference scans a layer-stacked tree); the serving cache is a list with
one ``KVCache`` per layer.  Entry points: init_params, forward,
init_cache, prefill, decode_step.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from . import modules as M


def torch_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def validate_family(cfg) -> None:
    """The port serves the dense family; the others are later slices."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (dense only)")
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet")
    if cfg.attn_window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")


class Block(nn.Module):
    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
                 attn: L.Attention, mlp: nn.Module):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)
        self.attn = attn
        self.mlp = mlp


class Transformer(nn.Module):
    def __init__(self, embedding: torch.Tensor, blocks: List[Block],
                 final_norm: torch.Tensor, lm_head: Optional[M.Dense]):
        super().__init__()
        self.register_buffer("embedding", embedding)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head


def _block_init(gen, cfg, dtype, device) -> Block:
    attn = L.attention_init(gen, cfg, dtype, device)
    if cfg.mlp_type == "gelu":
        mlp = L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    else:
        mlp = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    # norm scales stay f32, as in the reference
    return Block(M.norm_scale_init(cfg.d_model, device=device),
                 M.norm_scale_init(cfg.d_model, device=device), attn, mlp)


def init_params(gen: torch.Generator, cfg, device) -> Transformer:
    """Random init from ``gen`` (the generator must live on ``device``;
    ``models.api.init_params`` resolves the device)."""
    validate_family(cfg)
    dtype = torch_dtype(cfg)
    emb = M.embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    blocks = [_block_init(gen, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    head = (None if cfg.tie_embeddings else
            M.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                         device=device))
    return Transformer(emb, blocks, M.norm_scale_init(cfg.d_model,
                                                      device=device), head)


def block_apply(p: Block, x: torch.Tensor, cfg,
                cache: Optional[L.KVCache] = None):
    h = M.rms_norm(p.ln1, x, cfg.norm_eps)
    a, new_cache = L.gqa_attention(p.attn, h, cfg, cache)
    x = x + a
    h = M.rms_norm(p.ln2, x, cfg.norm_eps)
    m = (L.gelu_mlp(p.mlp, h) if cfg.mlp_type == "gelu"
         else L.swiglu_mlp(p.mlp, h))
    return x + m, new_cache


def forward(model: Transformer, cfg, tokens: torch.Tensor,
            caches: Optional[List[L.KVCache]] = None
            ) -> Tuple[torch.Tensor, Optional[List[L.KVCache]], torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), new caches, aux loss (0))."""
    x = M.embed(model.embedding, tokens)
    new_caches = None if caches is None else []
    for i, blk in enumerate(model.blocks):
        x, c = block_apply(blk, x, cfg, None if caches is None else caches[i])
        if caches is not None:
            new_caches.append(c)
    x = M.rms_norm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        M._maybe_record("lm_head", x)
        logits = x @ model.embedding.to(x.dtype).T
    else:
        logits = M.dense(model.lm_head, x)
    return logits, new_caches, torch.zeros((), device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype,
               device) -> List[L.KVCache]:
    validate_family(cfg)
    return [L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                            dtype, device) for _ in range(cfg.n_layers)]


def prefill(model, cfg, tokens, caches, logits_at=None):
    """Prefill the cache with a full prompt; returns (logits (B, V), cache).
    ``logits_at`` selects the position read per row (the true last token
    when prompts are right-padded to a length bucket)."""
    logits, caches, _ = forward(model, cfg, tokens, caches)
    return L.select_logits(logits, logits_at), caches


def decode_step(model, cfg, token: torch.Tensor, caches):
    """token (B,) or (B, 1) -> (logits (B, V), new caches)."""
    if token.dim() == 1:
        token = token[:, None]
    logits, caches, _ = forward(model, cfg, token, caches)
    return logits[:, -1], caches
