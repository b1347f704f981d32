"""Family-agnostic model API (port of ``repro.models.api``): every family
of the reference — dense and moe (GQA or MLA attention), rwkv, the hybrid
and encdec.  encdec dispatches to ``encdec.py``: ``make_cache`` needs its
``src_len`` and ``prefill_step`` its ``batch["frames"]``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import device as dev_lib

from . import encdec as ed
from . import transformer as tf


def init_params(gen: torch.Generator, cfg, device="cuda"):
    if cfg.family == "encdec":
        return ed.encdec_init(gen, cfg, dev_lib.resolve(device))
    return tf.init_params(gen, cfg, dev_lib.resolve(device))


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor]):
    """Next-token loss and its metrics: {"nll", "aux"} (see
    transformer.lm_loss), encdec {"nll"} (encdec.encdec_loss)."""
    if cfg.family == "encdec":
        return ed.encdec_loss(params, cfg, batch)
    tf.validate_family(cfg)
    return tf.lm_loss(params, cfg, batch)


def make_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", *, src_len: Optional[int] = None,
               page_size: Optional[int] = None,
               n_pages: Optional[int] = None, kv_dtype=None):
    """Per-layer caches; ``page_size``/``n_pages``/``kv_dtype`` switch to
    the paged layout (see transformer.init_cache).  encdec REQUIRES
    ``src_len``: its cross-attention strips are written once at prefill
    from exactly ``src_len`` encoder rows and never grow."""
    if cfg.family == "encdec":
        if page_size is not None:
            tf.validate_paged_support(cfg)    # raises: encdec is not paged
        if src_len is None:
            raise ValueError(
                "make_cache: encdec needs the actual src_len — the cross "
                "cache is written once at prefill and never grows, so "
                "there is no meaningful default")
        return ed.init_encdec_cache(cfg, batch, max_len, src_len, dtype,
                                    dev_lib.resolve(device))
    return tf.init_cache(cfg, batch, max_len, dtype, dev_lib.resolve(device),
                         page_size=page_size, n_pages=n_pages,
                         kv_dtype=kv_dtype)


def prefill_step(params, cfg, batch: Dict[str, torch.Tensor], cache,
                 logits_at=None):
    """``batch["tokens"]`` (B, S), after ``batch["prefix_embeds"]`` (B, P,
    D) when given (encdec: over the encoded ``batch["frames"]`` (B, Ss,
    D)); ``logits_at`` (scalar or (B,)) picks the position whose logits
    are returned (default: the last)."""
    if cfg.family == "encdec":
        return ed.encdec_prefill(params, cfg, batch["frames"],
                                 batch["tokens"], cache, logits_at=logits_at)
    tf.validate_family(cfg)
    return tf.prefill(params, cfg, batch["tokens"], cache,
                      logits_at=logits_at,
                      prefix_embeds=batch.get("prefix_embeds"))


def decode_step(params, cfg, token: torch.Tensor, cache):
    if cfg.family == "encdec":
        return ed.encdec_decode_step(params, cfg, token, cache)
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
