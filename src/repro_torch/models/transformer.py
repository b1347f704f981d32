"""Decoder LM for every decoder-only family (port of
``repro.models.transformer``): dense and moe with GQA or MLA attention,
rwkv (RWKV6 time-mix / channel-mix blocks, layer norms) and the
Zamba2-style hybrid (Mamba2 layers with one shared attention block, GQA
over a sliding-window ring cache, called before each ``attn_every``-layer
segment with a per-site LoRA delta).  encdec lives in ``encdec.py``.

Blocks live in an ``nn.ModuleList`` and run in a Python loop (the
reference scans a layer-stacked tree); the serving cache is a flat list
whose every element has ``.length``: one cache per layer (``KVCache`` /
``PagedKVCache``, MLA ``MLACache`` / ``PagedMLACache``, ``RWKVCache``,
``MambaCache``), the hybrid's layer caches followed by one ring
``KVCache`` a shared-attention site (the reference's ``{"mamba",
"attn"}``).  ``forward`` returns the MoE aux loss summed over layers (0
from a cached forward: serving never reads it).
With ``cfg.remat`` and grad enabled each block is recomputed in the
backward pass (``torch.utils.checkpoint``), as the reference remats its
scan body.  Entry points: init_params, forward, lm_loss, init_cache,
prefill, decode_step, decode_span.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import context as dctx

from . import layers as L
from . import mamba2 as m2
from . import mla as mla_lib
from . import modules as M
from . import moe as moe_lib
from . import rwkv6 as rwkv

FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encdec")


def torch_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def validate_family(cfg) -> None:
    """Every family of the reference is ported; anything else is not a
    family."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"unknown model family {cfg.family!r}")


class Block(nn.Module):
    """``attn``: ``layers.Attention`` or ``mla.MLA``; ``mlp``: a SwiGLU, a
    GELU MLP or ``moe.MoE``."""

    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
                 attn: nn.Module, mlp: nn.Module):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)
        self.attn = attn
        self.mlp = mlp


class RWKVBlock(nn.Module):
    """Layer norms (scale and bias) around ``rwkv6.time_mix`` and
    ``channel_mix``."""

    def __init__(self, ln1, ln1_bias, ln2, ln2_bias, tm: rwkv.TimeMix,
                 cm: rwkv.ChannelMix):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln1_bias", ln1_bias)
        self.register_buffer("ln2", ln2)
        self.register_buffer("ln2_bias", ln2_bias)
        self.tm, self.cm = tm, cm


class HybridLayer(nn.Module):
    """An RMS norm before a Mamba2 block (taps ``layers.{i}.mamba.*``)."""

    def __init__(self, ln, mamba: m2.Mamba):
        super().__init__()
        self.register_buffer("ln", ln)
        self.mamba = mamba


class SharedAttention(L.Attention):
    """The hybrid's shared transformer block: GQA attention (q, k, v, o),
    its norms ``ln`` / ``ln2`` and a SwiGLU ``mlp``."""

    def __init__(self, q, k, v, o, ln, ln2, mlp, q_norm=None, k_norm=None):
        super().__init__(q, k, v, o, q_norm, k_norm)
        self.register_buffer("ln", ln)
        self.register_buffer("ln2", ln2)
        self.mlp = mlp


class SiteLora(nn.Module):
    """A shared-attention site's LoRA delta (D x 32, 32 x H * hd)."""

    def __init__(self, lora_a, lora_b):
        super().__init__()
        self.register_buffer("lora_a", lora_a)
        self.register_buffer("lora_b", lora_b)


class Transformer(nn.Module):
    def __init__(self, embedding: torch.Tensor, blocks: List[nn.Module],
                 final_norm: torch.Tensor, lm_head: Optional[M.Dense],
                 final_norm_bias: Optional[torch.Tensor] = None,
                 shared_attn: Optional[SharedAttention] = None,
                 site_lora: Optional[List[SiteLora]] = None):
        super().__init__()
        self.register_buffer("embedding", embedding)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.register_buffer("final_norm_bias", final_norm_bias)  # rwkv
        self.lm_head = lm_head
        self.shared_attn = shared_attn
        self.site_lora = (None if site_lora is None
                          else nn.ModuleList(site_lora))


def _block_init(gen, cfg, dtype, device) -> nn.Module:
    D = cfg.d_model
    if cfg.family == "rwkv":
        tm, cm = rwkv.rwkv_init(gen, cfg, dtype, device)
        zeros = dict(dtype=torch.float32, device=device)
        return RWKVBlock(M.norm_scale_init(D, device=device),
                         torch.zeros((D,), **zeros),
                         M.norm_scale_init(D, device=device),
                         torch.zeros((D,), **zeros), tm, cm)
    if cfg.family == "hybrid":
        return HybridLayer(M.norm_scale_init(D, device=device),
                           m2.mamba_init(gen, cfg, dtype, device))
    if cfg.use_mla:
        attn = mla_lib.mla_init(gen, cfg, dtype, device)
    else:
        attn = L.attention_init(gen, cfg, dtype, device)
    if cfg.family == "moe":
        mlp = moe_lib.moe_init(gen, cfg, dtype, device)
    elif cfg.mlp_type == "gelu":
        mlp = L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    else:
        mlp = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    # norm scales stay f32, as in the reference
    return Block(M.norm_scale_init(cfg.d_model, device=device),
                 M.norm_scale_init(cfg.d_model, device=device), attn, mlp)


LORA_RANK = 32


def _shared_init(gen, cfg, dtype, device):
    """(SharedAttention, [SiteLora] * n_sites) of the hybrid."""
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    a = L.attention_init(gen, cfg, dtype, device)
    shared = SharedAttention(a.q, a.k, a.v, a.o,
                             M.norm_scale_init(D, device=device),
                             M.norm_scale_init(D, device=device),
                             L.swiglu_init(gen, D, cfg.d_ff, dtype, device),
                             a.q_norm, a.k_norm)
    f32 = dict(dtype=torch.float32, device=device)
    sites = [SiteLora(
        (torch.randn((D, LORA_RANK), generator=gen, **f32)
         * D ** -0.5).to(dtype),
        (torch.randn((LORA_RANK, H * hd), generator=gen, **f32)
         * 0.01).to(dtype)) for _ in range(cfg.n_sites)]
    return shared, sites


def init_params(gen: torch.Generator, cfg, device) -> Transformer:
    """Random init from ``gen`` (the generator must live on ``device``;
    ``models.api.init_params`` resolves the device and routes encdec)."""
    validate_family(cfg)
    dtype = torch_dtype(cfg)
    emb = M.embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    blocks = [_block_init(gen, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    head = (None if cfg.tie_embeddings else
            M.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                         device=device))
    shared = sites = None
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        shared, sites = _shared_init(gen, cfg, dtype, device)
    bias = (torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
            if cfg.family == "rwkv" else None)
    return Transformer(emb, blocks, M.norm_scale_init(cfg.d_model,
                                                      device=device), head,
                       final_norm_bias=bias, shared_attn=shared,
                       site_lora=sites)


def block_apply(p: nn.Module, x: torch.Tensor, cfg, cache=None,
                span: bool = False):
    """One block: (x, new cache, aux loss)."""
    zero = torch.zeros((), device=x.device)
    if cfg.family == "rwkv":
        h = M.layer_norm(p.ln1, p.ln1_bias, x, cfg.norm_eps)
        a, state, last_tm = rwkv.time_mix(p.tm, h, cfg, cache)
        x = x + a
        h2 = M.layer_norm(p.ln2, p.ln2_bias, x, cfg.norm_eps)
        c, last_cm = rwkv.channel_mix(p.cm, h2, cache)
        new_cache = None
        if cache is not None:
            new_cache = rwkv.RWKVCache(
                state=state, prev_tm=last_tm.to(cache.prev_tm.dtype),
                prev_cm=last_cm.to(cache.prev_cm.dtype),
                length=cache.length + h.shape[1])
        return x + c, new_cache, zero
    if cfg.family == "hybrid":
        m, new_cache = m2.mamba_block(p.mamba, M.rms_norm(p.ln, x,
                                                          cfg.norm_eps),
                                      cfg, cache)
        return x + m, new_cache, zero
    h = M.rms_norm(p.ln1, x, cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = mla_lib.mla_attention(p.attn, h, cfg, cache, span=span)
    else:
        a, new_cache = L.gqa_attention(p.attn, h, cfg, cache, span=span)
    x = x + a
    h = M.rms_norm(p.ln2, x, cfg.norm_eps)
    aux = zero
    if cfg.family == "moe":
        # a cached forward (serving) never reads the aux loss
        m, aux = moe_lib.moe_mlp(p.mlp, h, cfg, aux=cache is None)
    elif cfg.mlp_type == "gelu":
        m = L.gelu_mlp(p.mlp, h)
    else:
        m = L.swiglu_mlp(p.mlp, h)
    return x + m, new_cache, aux


def _shared_attention(model: Transformer, x, cfg, site: int, cache):
    """The Zamba2-style shared block at ``site``: attention plus the
    site's LoRA delta, folded through the output projection a second time
    (tap ``o_lora``), then the SwiGLU; taps ``shared_attn.site{s}.*``."""
    sp = model.shared_attn
    h = M.rms_norm(sp.ln, x, cfg.norm_eps)
    lora = model.site_lora[site]
    with M.tap_scope(f"shared_attn.site{site}"):
        out, new_cache = L.gqa_attention(sp, h, cfg, cache)
        delta = M.linear(M.linear(h, lora.lora_a), lora.lora_b)
        out = out + M.dense(sp.o, delta, tap="o_lora")
        x = x + out
        h2 = M.rms_norm(sp.ln2, x, cfg.norm_eps)
        x = x + L.swiglu_mlp(sp.mlp, h2)
    return x, new_cache


def _apply(blk, x, cfg, cache, span, remat):
    if remat:
        # the recompute runs in the backward, which the autograd engine
        # runs on a thread of its own for CUDA tensors: it re-enters the
        # forward's mesh context there (the sharded layers read it)
        state = dctx.snapshot()
        return checkpoint(block_apply, blk, x, cfg, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              dctx.restore(state)))
    return block_apply(blk, x, cfg, cache, span=span)


def forward(model: Transformer, cfg, tokens: Optional[torch.Tensor],
            caches: Optional[List] = None, span: bool = False,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[List], torch.Tensor]:
    """tokens (B, S) -> (logits (B, P + S, V), new caches, aux loss summed
    over layers).  ``prefix_embeds`` (B, P, D), the modality stub
    (precomputed patch embeddings), is prepended to the token embeddings.
    ``span``: the S tokens append at each slot's own fill level (see
    ``layers.gqa_attention``)."""
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(torch_dtype(cfg)))
    if tokens is not None:
        parts.append(M.embed(model.embedding, tokens))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches = None if caches is None else list(caches)
    aux_sum = torch.zeros((), device=x.device)
    n_layers = len(model.blocks)
    # the hybrid: a shared-attention site before each attn_every-layer
    # segment; its caches follow the layers'
    hybrid = model.shared_attn is not None
    per = cfg.attn_every if hybrid else n_layers
    for i, blk in enumerate(model.blocks):
        if hybrid and i % per == 0:
            site = i // per
            x, c = _shared_attention(
                model, x, cfg, site,
                None if caches is None else caches[n_layers + site])
            if caches is not None:
                new_caches[n_layers + site] = c
        x, c, aux = _apply(blk, x, cfg, None if caches is None
                           else caches[i], span, remat)
        aux_sum = aux_sum + aux
        if caches is not None:
            new_caches[i] = c
    if model.final_norm_bias is not None:
        x = M.layer_norm(model.final_norm, model.final_norm_bias, x,
                         cfg.norm_eps)
    else:
        x = M.rms_norm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        M._maybe_record("lm_head", x)
        logits = M.tied_logits(x, model.embedding)
    else:
        logits = M.dense(model.lm_head, x)
    return logits, new_caches, aux_sum


def lm_loss(model: Transformer, cfg, batch: Dict[str, torch.Tensor]):
    """Next-token loss.  batch: tokens (B, S) [+ prefix_embeds (B, P, D)]
    [+ loss_mask (B, S)].  Returns (nll + 0.01 * aux, {"nll", "aux"})."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    logits, _, aux = forward(model, cfg, tokens, prefix_embeds=prefix)
    P = 0 if prefix is None else prefix.shape[1]
    logp = F.log_softmax(logits[:, P:-1].float(), dim=-1)  # predicts [1:]
    nll = -torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def validate_paged_support(cfg) -> None:
    """Which configs can serve from a paged KV cache: position-indexed,
    fill-masked, non-ring cache storage (the page table replays the
    contiguous layout exactly)."""
    if cfg.family in ("rwkv", "hybrid"):
        raise NotImplementedError(
            f"paged KV cache: the {cfg.family} family keeps recurrent "
            f"state, not per-position K/V rows — there is nothing to page")
    if cfg.family == "encdec":
        raise NotImplementedError(
            "paged KV cache: encdec serving is unsupported (ServingEngine "
            "rejects the family at construction)")
    if cfg.attn_window is not None:
        raise NotImplementedError(
            "paged KV cache: sliding-window ring caches index slots by "
            "position % W, which a page table does not reproduce")


def init_cache(cfg, batch: int, max_len: int, dtype, device, *,
               page_size: Optional[int] = None,
               n_pages: Optional[int] = None, kv_dtype=None) -> List:
    """One cache per layer (MLA: the latent c_kv/k_pe strips; rwkv and
    the hybrid's layers: recurrent state), the hybrid's ring caches of
    ``min(max_len, attn_window)`` rows after them.  With
    ``page_size`` set, each layer gets a paged pool instead of contiguous
    strips, all layers sharing one page table (``n_pages`` defaults to
    contiguous capacity, batch * max_len tokens; ``kv_dtype='int8'``
    stores resident pages quantized)."""
    if page_size is not None:
        validate_paged_support(cfg)
    validate_family(cfg)
    if page_size is None:
        if cfg.family == "rwkv":
            return [rwkv.init_rwkv_cache(batch, cfg, dtype, device)
                    for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            attn_len = min(max_len, cfg.attn_window or max_len)
            return ([m2.init_mamba_cache(batch, cfg, dtype, device)
                     for _ in range(cfg.n_layers)]
                    + [L.init_kv_cache(batch, attn_len, cfg.n_kv_heads,
                                       cfg.head_dim, dtype, device)
                       for _ in range(cfg.n_sites)])
        if cfg.use_mla:
            return [mla_lib.init_mla_cache(batch, max_len, cfg, dtype, device)
                    for _ in range(cfg.n_layers)]
        return [L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                                dtype, device) for _ in range(cfg.n_layers)]
    if n_pages is None:
        n_pages = batch * (max_len // page_size)
    table = torch.full((batch, max_len // page_size), n_pages,
                       dtype=torch.long, device=device)
    kw = dict(page_size=page_size, n_pages=n_pages, dtype=dtype,
              kv_dtype=kv_dtype, device=device, table=table)
    if cfg.use_mla:
        return [mla_lib.init_paged_mla_cache(batch, max_len, cfg, **kw)
                for _ in range(cfg.n_layers)]
    return [L.init_paged_kv_cache(batch, max_len, cfg.n_kv_heads,
                                  cfg.head_dim, **kw)
            for _ in range(cfg.n_layers)]


def prefill(model, cfg, tokens, caches, logits_at=None, prefix_embeds=None):
    """Prefill the cache with a full prompt (after ``prefix_embeds``, when
    given); returns (logits (B, V), cache).  ``logits_at`` selects the
    position read per row (the true last token when prompts are
    right-padded to a length bucket)."""
    logits, caches, _ = forward(model, cfg, tokens, caches,
                                prefix_embeds=prefix_embeds)
    return L.select_logits(logits, logits_at), caches


def decode_step(model, cfg, token: torch.Tensor, caches):
    """token (B,) or (B, 1) -> (logits (B, V), new caches)."""
    if token.dim() == 1:
        token = token[:, None]
    logits, caches, _ = forward(model, cfg, token, caches)
    return logits[:, -1], caches


def validate_span_support(cfg) -> None:
    """Which configs support span decode: an S-token span call is exactly
    S successive decode steps and a rejected tail can be rolled back.  The
    engine's speculation gate calls this too, so the two cannot drift."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "span decode: encdec serving is unsupported (ServingEngine "
            "rejects the family at construction)")
    if cfg.family in ("rwkv", "hybrid"):
        raise NotImplementedError(
            f"span decode: the {cfg.family} family folds every token into "
            f"recurrent state (rwkv wkv / the hybrid's mamba2 SSM), which "
            f"cannot be rolled back after a rejected speculation window; "
            f"serve it without speculation")
    if cfg.family == "moe":
        raise NotImplementedError(
            "span decode: moe's capacity-bounded router couples the span "
            "tokens (cap and the group-local cumsum depend on token "
            "count), so span logits would differ from successive decode "
            "steps and greedy speculation would not be lossless; serve "
            "moe without speculation")
    if cfg.attn_window is not None:
        raise NotImplementedError(
            "span decode: a sliding-window ring cache keeps only the LAST "
            "W keys (slot = position % W) — a span write would clobber "
            "evicted keys and rollback cannot restore them; serve "
            "windowed configs without speculation")


def decode_span(model, cfg, tokens: torch.Tensor, caches):
    """Append S = tokens.shape[1] tokens at each slot's OWN fill level and
    return the logits at every span position: (B, S, V), new caches — the
    speculative verify, the computation of S successive decode steps."""
    validate_span_support(cfg)
    logits, caches, _ = forward(model, cfg, tokens, caches, span=True)
    return logits, caches
