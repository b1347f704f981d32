"""Encoder-decoder backbone (port of ``repro.models.encdec``, the
seamless-m4t-medium text/unit path).

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, D).  Decoder layer = causal self-attention +
cross-attention + GELU MLP.  Serving caches the decoder self-attention
K/V (one ``KVCache`` a layer, updated in place as the decoder-only
families' are) and the cross-attention K/V, projected once from the
encoder output at prefill and stacked over layers as in the reference.
Calibration taps are named ``enc.{i}.attn.q`` / ``dec.{i}.cross.q``.  The
cross K/V projections record none: the quantizer looks them up as
``dec.{i}.cross.k`` and finds no Hessian in either package (the
reference's own tap there, inside ``lax.map``, leaks a tracer, so its
``calibrate`` raises on this family; see ROADMAP.md).

On a (data, model) mesh every product is placed on its out dim and
gathered, as in the decoder-only families.  The encoder and a cacheless
decoder (training) attend with every head on every rank; with a placed
cache (``dist.sharding.place_cache``: ``self_kv`` and the cross banks hold
a block of the KV heads over "model" and of the slots over "dp") the
decoder's self- and cross-attention run head-parallel on that block.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx

from . import layers as L
from . import modules as M
from .transformer import torch_dtype


class EncDecCache(NamedTuple):
    self_kv: List[L.KVCache]   # one per decoder layer
    cross_k: torch.Tensor      # (L_dec, B, S_src, KH, hd)
    cross_v: torch.Tensor
    enc_len: torch.Tensor      # (B,) int32


class CrossAttention(nn.Module):
    def __init__(self, q, k, v, o):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o


class EncBlock(nn.Module):
    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.attn = attn
        self.register_buffer("ln2", ln2)
        self.mlp = mlp


class DecBlock(nn.Module):
    def __init__(self, ln1, attn, ln_x, cross, ln2, mlp):
        super().__init__()
        self.register_buffer("ln1", ln1)
        self.attn = attn
        self.register_buffer("ln_x", ln_x)
        self.cross = cross
        self.register_buffer("ln2", ln2)
        self.mlp = mlp


class EncDec(nn.Module):
    def __init__(self, embedding, enc_blocks, dec_blocks, enc_norm,
                 final_norm, lm_head):
        super().__init__()
        self.register_buffer("embedding", embedding)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.register_buffer("enc_norm", enc_norm)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head


def _cross_init(gen, cfg, dtype, device) -> CrossAttention:
    H, KH, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return CrossAttention(M.dense_init(gen, D, H * hd, **kw),
                          M.dense_init(gen, D, KH * hd, **kw),
                          M.dense_init(gen, D, KH * hd, **kw),
                          M.dense_init(gen, H * hd, D, **kw))


def encdec_init(gen: torch.Generator, cfg, device) -> EncDec:
    dtype = torch_dtype(cfg)
    D = cfg.d_model

    def norm():
        return M.norm_scale_init(D, device=device)

    def mlp():
        return L.gelu_mlp_init(gen, D, cfg.d_ff, dtype, device)

    enc = [EncBlock(norm(), L.attention_init(gen, cfg, dtype, device),
                    norm(), mlp()) for _ in range(cfg.enc_layers)]
    dec = [DecBlock(norm(), L.attention_init(gen, cfg, dtype, device),
                    norm(), _cross_init(gen, cfg, dtype, device), norm(),
                    mlp()) for _ in range(cfg.dec_layers)]
    return EncDec(M.embed_init(gen, cfg.vocab, D, dtype, device), enc, dec,
                  norm(), norm(),
                  M.dense_init(gen, D, cfg.vocab, dtype=dtype, device=device))


def _cross_attention(p: CrossAttention, x, enc_kv, cfg, enc_len=None):
    """x (B, St, D) queries over the encoder K/V (B, Ss, KH, hd).  A bank
    of a block of the KV heads (a cache placed over "model") attends
    head-parallel, as ``layers.gqa_attention`` does on a placed cache:
    the rank takes its heads of q (through ``coll.replicated``), attends
    them over its block and all-gathers the heads over "model" before
    ``o``; each head's arithmetic is the single device's."""
    B, St, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = M.dense(p.q, x).reshape(B, St, H, hd)
    k, v = enc_kv
    block = L.kv_head_block(cfg, k.shape[-2])
    if block is not None:
        parts, r = block
        q = coll.replicated(q)[:, :, r * H // parts:(r + 1) * H // parts]
    out = L.blocked_attention(q, k.to(x.dtype), v.to(x.dtype), causal=False,
                              kv_len=enc_len, q_block=cfg.q_block,
                              kv_block=cfg.kv_block)
    if block is not None:
        out = coll.all_gather(out, dim=2)
    return M.dense(p.o, out.reshape(B, St, H * hd))


def _enc_layer(p: EncBlock, h, cfg):
    hn = M.rms_norm(p.ln1, h, cfg.norm_eps)
    B, S, _ = hn.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = M.dense(p.attn.q, hn).reshape(B, S, H, hd)
    k = M.dense(p.attn.k, hn).reshape(B, S, KH, hd)
    v = M.dense(p.attn.v, hn).reshape(B, S, KH, hd)
    pos = torch.arange(S, device=h.device)[None].expand(B, S)
    cos, sin = L.rope_angles(pos, cfg.rotary_dim or hd, cfg.rope_theta)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    a = L.blocked_attention(q, k, v, causal=False, q_block=cfg.q_block,
                            kv_block=cfg.kv_block)
    h = h + M.dense(p.attn.o, a.reshape(B, S, H * hd))
    hn = M.rms_norm(p.ln2, h, cfg.norm_eps)
    return h + L.gelu_mlp(p.mlp, hn)


def encode(model: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_src, D) -> encoder states; bidirectional
    self-attention."""
    x = frames.to(torch_dtype(cfg))
    for blk in model.enc_blocks:
        x = _enc_layer(blk, x, cfg)
    return M.rms_norm(model.enc_norm, x, cfg.norm_eps)


def _dec_layer(p: DecBlock, x, cfg, enc_kv, enc_len, cache):
    h = M.rms_norm(p.ln1, x, cfg.norm_eps)
    a, new_cache = L.gqa_attention(p.attn, h, cfg, cache)
    x = x + a
    h = M.rms_norm(p.ln_x, x, cfg.norm_eps)
    x = x + _cross_attention(p.cross, h, enc_kv, cfg, enc_len)
    h = M.rms_norm(p.ln2, x, cfg.norm_eps)
    return x + L.gelu_mlp(p.mlp, h), new_cache


def _project_cross_kv(model: EncDec, cfg, enc_out):
    """Per-decoder-layer cross K/V from the encoder states, stacked
    (L_dec, B, Ss, KH, hd); no calibration taps."""
    B, Ss, _ = enc_out.shape
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    with M.no_taps():
        ks = [M.dense(b.cross.k, enc_out).reshape(B, Ss, KH, hd)
              for b in model.dec_blocks]
        vs = [M.dense(b.cross.v, enc_out).reshape(B, Ss, KH, hd)
              for b in model.dec_blocks]
    return torch.stack(ks), torch.stack(vs)


def decode_blocks(model: EncDec, cfg, x, enc_out=None, cross_kv=None,
                  enc_len=None, caches: Optional[List] = None):
    """The decoder stack: (x, new self-attention caches or None,
    (cross_k, cross_v))."""
    if cross_kv is None:
        cross_kv = _project_cross_kv(model, cfg, enc_out)
    ck, cv = cross_kv
    new_caches = None if caches is None else []
    for i, blk in enumerate(model.dec_blocks):
        x, c = _dec_layer(blk, x, cfg, (ck[i], cv[i]), enc_len,
                          None if caches is None else caches[i])
        if caches is not None:
            new_caches.append(c)
    return x, new_caches, (ck, cv)


def encdec_loss(model: EncDec, cfg, batch: Dict[str, torch.Tensor]):
    """batch: frames (B, Ss, D), tokens (B, St).  Returns (nll,
    {"nll"})."""
    enc_out = encode(model, cfg, batch["frames"])
    x = M.embed(model.embedding, batch["tokens"])
    x, _, _ = decode_blocks(model, cfg, x, enc_out=enc_out)
    x = M.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = M.dense(model.lm_head, x)
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = batch["tokens"][:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return nll.mean(), {"nll": nll.mean()}


def init_encdec_cache(cfg, batch: int, max_len: int, src_len: int,
                      dtype=torch.bfloat16, device=None) -> EncDecCache:
    kv = dict(dtype=dtype, device=device)
    shape = (cfg.dec_layers, batch, src_len, cfg.n_kv_heads, cfg.head_dim)
    return EncDecCache(
        self_kv=[L.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim, dtype, device)
                 for _ in range(cfg.dec_layers)],
        cross_k=torch.zeros(shape, **kv), cross_v=torch.zeros(shape, **kv),
        enc_len=torch.zeros((batch,), dtype=torch.int32, device=device))


def _rank_rows(cache: EncDecCache, t):
    """This data rank's block of the rows of ``t`` (the global batch), in
    rank order over "dp", where ``cache`` holds that block; ``t``
    itself where it holds every row (or ``t`` is a scalar)."""
    rows = cache.enc_len.shape[0]
    if not isinstance(t, torch.Tensor) or t.dim() == 0 \
            or t.shape[0] == rows:
        return t
    mesh, index = dctx.get_mesh(), 0
    for a in dctx.physical_axes(mesh, "dp"):
        index = index * coll.axis_size(mesh, a) + coll.coordinate(mesh, a)
    return t[index * rows:(index + 1) * rows]


def encdec_prefill(model: EncDec, cfg, frames, tokens, cache: EncDecCache,
                   logits_at=None):
    """Decoder prefill over freshly encoded frames; returns (logits (B, V)
    at the last position, or at ``logits_at``, new cache).

    On a mesh the cache may be placed (``dist.sharding.place_cache``): the
    freshly projected cross K/V (whole heads) are cut to the bank's block
    of KV heads, and where the cache holds a data rank's block of the
    batch (its slots) and ``frames``/``tokens`` are the global batch, only
    that block's rows are encoded and prefilled (the logits are its
    rows')."""
    frames, tokens, logits_at = (_rank_rows(cache, t)
                                 for t in (frames, tokens, logits_at))
    enc_out = encode(model, cfg, frames)
    x = M.embed(model.embedding, tokens)
    ck, cv = _project_cross_kv(model, cfg, enc_out)
    block = L.kv_head_block(cfg, cache.cross_k.shape[-2])
    if block is not None:
        parts, r = block
        kh = cfg.n_kv_heads // parts
        ck, cv = (t[..., r * kh:(r + 1) * kh, :] for t in (ck, cv))
    x, self_kv, _ = decode_blocks(model, cfg, x, cross_kv=(ck, cv),
                                  caches=cache.self_kv)
    x = M.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = M.dense(model.lm_head, x)
    new_cache = EncDecCache(
        self_kv=self_kv, cross_k=ck.to(cache.cross_k.dtype),
        cross_v=cv.to(cache.cross_v.dtype),
        enc_len=torch.full((frames.shape[0],), frames.shape[1],
                           dtype=torch.int32, device=frames.device))
    return L.select_logits(logits, logits_at), new_cache


def encdec_decode_step(model: EncDec, cfg, token: torch.Tensor,
                       cache: EncDecCache):
    """token (B,) or (B, 1) -> (logits (B, V), new cache)."""
    if token.dim() == 1:
        token = token[:, None]
    x = M.embed(model.embedding, token)
    x, self_kv, _ = decode_blocks(model, cfg, x,
                                  cross_kv=(cache.cross_k, cache.cross_v),
                                  enc_len=cache.enc_len, caches=cache.self_kv)
    x = M.rms_norm(model.final_norm, x, cfg.norm_eps)
    logits = M.dense(model.lm_head, x)
    return logits[:, -1], cache._replace(self_kv=self_kv)
