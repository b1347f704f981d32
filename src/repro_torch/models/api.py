"""Family-agnostic model API (port of ``repro.models.api``): every family
of the reference — dense and moe (GQA or MLA attention), rwkv, the hybrid
and encdec.  encdec dispatches to ``encdec.py``: ``make_cache`` needs its
``src_len`` and ``prefill_step`` its ``batch["frames"]``.

On a mesh, every family alike: ``dist.sharding.place_model`` places the
model, ``make_cache``'s whole cache goes through
``dist.sharding.place_cache`` (a rank's slots over "dp", its KV heads over
"model"), and ``prefill_step``/``decode_step`` run under
``dist.context.use_mesh`` -- and ``rows_over_dp`` where the batch is a data
rank's block of rows, as a decode step over the rank's slots is."""
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


# ---------------------------------------------------------------------------
# Input specs for the dry run (meta tensors: shapes and dtypes, no memory)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, cell) -> Dict[str, torch.Tensor]:
    """Inputs of the cell's entry point (train loss / prefill / decode) as
    meta tensors of the reference's shapes and dtypes (``repro.models.
    api.input_specs``).  For modality archs the frontend is a stub:
    ``prefix_embeds`` / ``frames`` stand in for the precomputed patch /
    frame embeddings."""
    B, S = cell.global_batch, cell.seq_len
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cell.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"frames": _meta((B, S, cfg.d_model), act),
                    "tokens": _meta((B, S), torch.int32)}
        if cfg.modality == "vision":
            P = int(S * cfg.prefix_frac)
            return {"tokens": _meta((B, S - P), torch.int32),
                    "prefix_embeds": _meta((B, P, cfg.d_model), act)}
        return {"tokens": _meta((B, S), torch.int32)}
    # decode: one new token + a cache of seq_len
    return {"token": _meta((B,), torch.int32)}


def cache_specs(cfg, cell, dtype=torch.bfloat16):
    """The (filled) cache a decode / prefill cell uses, on ``meta``: the
    port's per-layer list (``sharding.cache_tree`` gives the reference's
    stacked layout of ``repro.models.api.cache_specs``)."""
    B, S = cell.global_batch, cell.seq_len
    src = S if cfg.family == "encdec" else None
    return make_cache(cfg, B, S, dtype=dtype, device="meta", src_len=src)
