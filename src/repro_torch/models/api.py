"""Family-agnostic model API (port of ``repro.models.api``): the dense and
moe families, with GQA or MLA attention; rwkv, hybrid, encdec and
sliding-window attention raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import device as dev_lib

from . import transformer as tf


def init_params(gen: torch.Generator, cfg, device="cuda"):
    return tf.init_params(gen, cfg, dev_lib.resolve(device))


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor]):
    """Next-token loss and {"nll", "aux"} (see transformer.lm_loss)."""
    tf.validate_family(cfg)
    return tf.lm_loss(params, cfg, batch)


def make_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", *, page_size: Optional[int] = None,
               n_pages: Optional[int] = None, kv_dtype=None):
    """Per-layer caches; ``page_size``/``n_pages``/``kv_dtype`` switch to
    the paged layout (see transformer.init_cache)."""
    return tf.init_cache(cfg, batch, max_len, dtype, dev_lib.resolve(device),
                         page_size=page_size, n_pages=n_pages,
                         kv_dtype=kv_dtype)


def prefill_step(params, cfg, batch: Dict[str, torch.Tensor], cache,
                 logits_at=None):
    """``batch["tokens"]`` (B, S), after ``batch["prefix_embeds"]`` (B, P,
    D) when given; ``logits_at`` (scalar or (B,)) picks the position whose
    logits are returned (default: the last)."""
    tf.validate_family(cfg)
    return tf.prefill(params, cfg, batch["tokens"], cache,
                      logits_at=logits_at,
                      prefix_embeds=batch.get("prefix_embeds"))


def decode_step(params, cfg, token: torch.Tensor, cache):
    tf.validate_family(cfg)
    return tf.decode_step(params, cfg, token, cache)


def validate_span_support(cfg) -> None:
    """Raise NotImplementedError unless span decode is exactly equivalent
    to successive decode steps on this config (see transformer.py)."""
    tf.validate_span_support(cfg)


def validate_paged_support(cfg) -> None:
    """Raise NotImplementedError unless this config can serve from a
    paged KV cache (see transformer.py)."""
    tf.validate_paged_support(cfg)


def decode_span(params, cfg, tokens: torch.Tensor, cache):
    """Speculative verify: append tokens (B, S) at each slot's own fill
    level; returns (logits (B, S, V), cache)."""
    return tf.decode_span(params, cfg, tokens, cache)
