"""Dense transformer layers (port of the dense parts of
``repro.models.layers``): RoPE, blocked online-softmax attention, GQA
attention with a contiguous KV cache, SwiGLU / GELU MLPs.

Attention is plain torch, as it is plain XLA in the reference: prefill
runs the blocked online-softmax formulation, single-token decode the
direct masked softmax, so each keeps the reference's arithmetic.  The
cache is updated IN PLACE (the reference returns a new cache): a
full-width cache is hundreds of MB, and copying it every step would double
decode's memory traffic.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import modules as M

NEG_INF = -1e30


def select_logits(logits: torch.Tensor, logits_at=None) -> torch.Tensor:
    """Pick one position per row from (B, S, V) logits: the last one, or
    ``logits_at`` (scalar or (B,) positions, e.g. the true last token of a
    right-padded prompt)."""
    if logits_at is None:
        return logits[:, -1]
    idx = torch.as_tensor(logits_at, device=logits.device).long()
    if idx.dim() == 0:
        idx = idx.expand(logits.shape[0])
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rotary_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, rotary_dim // 2)."""
    inv = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=positions.device)
                           / rotary_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D_rot/2).  Rotates the first D_rot
    dims, paired as [0::2], [1::2]."""
    d_rot = 2 * cos.shape[-1]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    y = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([y, xp], dim=-1) if xp.shape[-1] else y


# ---------------------------------------------------------------------------
# Blocked online-softmax attention
# ---------------------------------------------------------------------------

def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset=0,
                      kv_len: Optional[torch.Tensor] = None,
                      q_block: int = 512, kv_block: int = 1024,
                      window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, KH, D) -> (B, Sq, H, Dv).  Query
    blocks x kv blocks with an online softmax, f32 statistics."""
    B, Sq, H, D = q.shape
    _, Skv, KH, Dv = v.shape
    G = H // KH
    scale = D ** -0.5
    dev = q.device

    q_block = min(q_block, max(Sq, 1))
    kv_block = min(kv_block, max(Skv, 1))
    sq_p = -(-Sq // q_block) * q_block
    skv_p = -(-Skv // kv_block) * kv_block

    qh = F.pad(q, (0, 0, 0, 0, 0, sq_p - Sq))
    kh = F.pad(k, (0, 0, 0, 0, 0, skv_p - Skv))
    vh = F.pad(v, (0, 0, 0, 0, 0, skv_p - Skv))
    # (B,S,H,D) -> (B,KH,G,S,D) / (B,KH,S,D)
    qh = qh.transpose(1, 2).reshape(B, KH, G, sq_p, D) * scale
    kh = kh.transpose(1, 2).float()
    vh = vh.transpose(1, 2)

    q_pos = torch.as_tensor(q_offset, device=dev) + torch.arange(sq_p,
                                                                 device=dev)
    kv_pos = torch.arange(skv_p, device=dev)
    kv_lim = torch.as_tensor(Skv if kv_len is None else kv_len,
                             device=dev).expand(B)
    kv_valid = kv_pos[None, :] < kv_lim[:, None]               # (B, skv_p)

    outs = []
    for qi in range(sq_p // q_block):
        qb = qh[:, :, :, qi * q_block:(qi + 1) * q_block].float()
        qpos_b = q_pos[qi * q_block:(qi + 1) * q_block]
        m = torch.full((B, KH, G, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, KH, G, q_block), device=dev)
        acc = torch.zeros((B, KH, G, q_block, Dv), device=dev)
        for ki in range(skv_p // kv_block):
            sl = slice(ki * kv_block, (ki + 1) * kv_block)
            kc, vc, kpos_c = kh[:, :, sl], vh[:, :, sl], kv_pos[sl]
            s = torch.einsum("bkgqd,bksd->bkgqs", qb, kc)
            mask = kv_valid[:, sl][:, None, None, None, :]
            if causal:
                mask = mask & (kpos_c[None, :] <= qpos_b[:, None])
            if window is not None:
                mask = mask & (kpos_c[None, :] > qpos_b[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksv->bkgqv", p.to(vc.dtype).float(), vc.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                       # (B,KH,G,sq_p,Dv)
    out = out.reshape(B, H, sq_p, Dv).transpose(1, 2)[:, :Sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention with a contiguous KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_max, KH, D)
    v: torch.Tensor        # (B, S_max, KH, D)
    length: torch.Tensor   # (B,) int32 — filled entries per serving slot


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, kv_heads, head_dim), dtype=dtype,
                      device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


class Attention(nn.Module):
    def __init__(self, q, k, v, o, q_norm=None, k_norm=None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("k_norm", k_norm)


def gqa_attention(p: Attention, x: torch.Tensor, cfg,
                  cache: Optional[KVCache] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention.  Without a cache: causal self-attention.  With one:
    S == 1 appends at each slot's own fill level and attends the whole
    cache (decode); S > 1 appends at the uniform fill level
    ``cache.length[0]`` (prefill into a fresh or uniformly filled cache)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if getattr(cfg, "attn_window", None) is not None:
        raise NotImplementedError("sliding-window (ring cache) attention "
                                  "is not ported yet")

    q = M.dense(p.q, x).reshape(B, S, H, hd)
    k = M.dense(p.k, x).reshape(B, S, KH, hd)
    v = M.dense(p.v, x).reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = M.rms_norm(p.q_norm, q, cfg.norm_eps)
        k = M.rms_norm(p.k_norm, k, cfg.norm_eps)

    dev = x.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    if cache is not None:
        positions = cache.length[:, None].long() + positions
    rot = cfg.rotary_dim or hd
    cos, sin = rope_angles(positions, rot, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = blocked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                kv_block=cfg.kv_block)
        new_cache = None
    elif S == 1:
        # decode: write at each slot's own fill level.  A free slot's
        # counter keeps growing with the batch; clamping keeps its write in
        # bounds (its row is overwritten whole when the slot is reused).
        brange = torch.arange(B, device=dev)
        idx = cache.length.long().clamp(max=cache.k.shape[1] - 1)
        cache.k[brange, idx] = k[:, 0].to(cache.k.dtype)
        cache.v[brange, idx] = v[:, 0].to(cache.v.dtype)
        new_len = cache.length + 1
        out = _decode_attention(q, cache.k, cache.v, new_len)
        new_cache = KVCache(cache.k, cache.v, new_len)
    else:
        # prefill at the uniform fill level of the batch
        start = cache.length[0].long()
        pos = start + torch.arange(S, device=dev)
        cache.k[:, pos] = k.to(cache.k.dtype)
        cache.v[:, pos] = v.to(cache.v.dtype)
        new_len = cache.length + S
        out = blocked_attention(q, cache.k, cache.v, causal=True,
                                q_offset=start, kv_len=new_len,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
        new_cache = KVCache(cache.k, cache.v, new_len)

    out = out.reshape(B, S, H * hd)
    return M.dense(p.o, out), new_cache


def _decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token decode: q (B,1,H,D) against the whole cache, direct
    masked softmax; kv_len (B,) valid entries per slot.  Operands are taken
    in the cache's dtype and multiplied in f32, as the reference's
    f32-accumulating einsum does."""
    B, _, H, D = q.shape
    _, S, KH, Dv = v_cache.shape
    G = H // KH
    qh = (q.reshape(B, KH, G, D) * (D ** -0.5)).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, None, :] < kv_len.long()[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def attention_init(gen: torch.Generator, cfg, dtype=torch.float32,
                   device=None) -> Attention:
    H, KH, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    q = M.dense_init(gen, D, H * hd, bias=cfg.qkv_bias, **kw)
    k = M.dense_init(gen, D, KH * hd, bias=cfg.qkv_bias, **kw)
    v = M.dense_init(gen, D, KH * hd, bias=cfg.qkv_bias, **kw)
    o = M.dense_init(gen, H * hd, D, **kw)
    qn = kn = None
    if cfg.qk_norm:
        qn = M.norm_scale_init(hd, dtype, device)
        kn = M.norm_scale_init(hd, dtype, device)
    return Attention(q, k, v, o, qn, kn)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down


class GeluMLP(nn.Module):
    def __init__(self, up, down):
        super().__init__()
        self.up, self.down = up, down


def swiglu_mlp(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = M.dense(p.gate, x)
    u = M.dense(p.up, x)
    return M.dense(p.down, F.silu(g) * u)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return M.dense(p.down, F.gelu(M.dense(p.up, x), approximate="tanh"))


def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device=None) -> SwiGLU:
    kw = dict(dtype=dtype, device=device)
    return SwiGLU(M.dense_init(gen, d_model, d_ff, **kw),
                  M.dense_init(gen, d_model, d_ff, **kw),
                  M.dense_init(gen, d_ff, d_model, **kw))


def gelu_mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32,
                  device=None) -> GeluMLP:
    kw = dict(dtype=dtype, device=device)
    return GeluMLP(M.dense_init(gen, d_model, d_ff, **kw),
                   M.dense_init(gen, d_ff, d_model, **kw))
