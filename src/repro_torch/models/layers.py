"""Dense transformer layers (port of ``repro.models.layers``): RoPE,
blocked online-softmax attention, GQA attention with a contiguous, a
paged or (sliding window) a ring KV cache, SwiGLU / GELU MLPs.

Attention is plain torch, as it is plain XLA in the reference: prefill
runs the blocked online-softmax formulation, single-token decode the
direct masked softmax, and span decode (speculative verify) the same
masked softmax over S query rows, so each keeps the reference's
arithmetic.  Caches are updated IN PLACE (the reference returns a new
cache): a full-width cache is hundreds of MB, and copying it every step
would double decode's memory traffic.

On a mesh, attention is head-parallel over "model" when the engine's
cache holds this rank's block of the KV heads (``dist.sharding.
spec_for_cache`` splits them where ``n_kv_heads`` divides): the rank
takes its heads of the replicated q/k/v projections, attends them over
its cache block, and the heads are all-gathered before the output
projection.  Each head's arithmetic is the unsharded one's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx
from repro_torch.kernels import ops as kops

from . import modules as M

NEG_INF = -1e30


def select_logits(logits: torch.Tensor, logits_at=None) -> torch.Tensor:
    """Pick positions per row from (B, S, V) logits: the last one, or
    ``logits_at`` — scalar or (B,) positions (e.g. the true last token of
    a right-padded prompt) give (B, V); (B, T) positions give (B, T, V)."""
    if logits_at is None:
        return logits[:, -1]
    idx = torch.as_tensor(logits_at, device=logits.device).long()
    if idx.dim() == 0:
        idx = idx.expand(logits.shape[0])
    rows = torch.arange(logits.shape[0], device=logits.device)
    if idx.dim() == 1:
        return logits[rows, idx]
    return logits[rows[:, None], idx]


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


# ---------------------------------------------------------------------------
# Paged KV cache: a global page pool per layer + per-slot page tables
# ---------------------------------------------------------------------------
# Pool row ``n_pages`` is the SCRATCH page: it absorbs every write a
# contiguous cache would mask or drop (free slots, span tails past
# max_len, unallocated blocks).  Reads gather ``pool[table]``, which
# rebuilds exactly the contiguous (B, max_pages * page_size, ...) view, so
# the masked-softmax attention runs the same ops on the same bits and
# paged fp decode reproduces contiguous decode's logits.  int8 pools store
# each token row absmax-quantized (``kernels.ops.quantize_activations``)
# with its scale beside it, dequantized at the gather (error <= scale/2).


class PagedKVCache(NamedTuple):
    kp: torch.Tensor                 # (n_pages+1, page_size, KH, D)
    vp: torch.Tensor                 # (n_pages+1, page_size, KH, D)
    k_scale: Optional[torch.Tensor]  # (n_pages+1, page_size) f32, int8 pool
    v_scale: Optional[torch.Tensor]
    table: torch.Tensor              # (B, max_pages) int64
    length: torch.Tensor             # (B,) int32


def init_paged_kv_cache(batch: int, max_len: int, kv_heads: int,
                        head_dim: int, *, page_size: int, n_pages: int,
                        dtype=torch.bfloat16, kv_dtype=None, device=None,
                        table: Optional[torch.Tensor] = None
                        ) -> PagedKVCache:
    """An empty pool, every table entry at scratch.  ``table`` lets the
    layers of one model share one table tensor (the engine mirrors it from
    the host)."""
    if max_len % page_size:
        raise ValueError(
            f"page_size {page_size} must divide max_len {max_len}")
    int8 = kv_dtype == "int8"
    pool_dtype = torch.int8 if int8 else dtype
    shape = (n_pages + 1, page_size, kv_heads, head_dim)

    def scale():
        return (torch.zeros((n_pages + 1, page_size), dtype=torch.float32,
                            device=device) if int8 else None)

    if table is None:
        table = torch.full((batch, max_len // page_size), n_pages,
                           dtype=torch.long, device=device)
    return PagedKVCache(
        kp=torch.zeros(shape, dtype=pool_dtype, device=device),
        vp=torch.zeros(shape, dtype=pool_dtype, device=device),
        k_scale=scale(), v_scale=scale(), table=table,
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def paged_write_ids(table: torch.Tensor, length: torch.Tensor, S: int,
                    page_size: int, scratch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page ids + within-page offsets (both (B, S)) for S tokens appended
    at each slot's fill level.  Positions past max_len and unallocated
    blocks route to the scratch page — the paged form of the contiguous
    paths' masking / dropped writes."""
    mp = table.shape[1]
    idx = (length.long()[:, None]
           + torch.arange(S, device=length.device)[None, :])
    blk = torch.clamp(idx // page_size, max=mp - 1)
    pid = torch.gather(table.long(), 1, blk)
    pid = torch.where(idx >= mp * page_size, scratch, pid)
    return pid, idx % page_size


def pool_write(pool: torch.Tensor, scale: Optional[torch.Tensor],
               pid: torch.Tensor, off: torch.Tensor,
               rows: torch.Tensor) -> None:
    """Scatter rows (B, S, feat...) into ``pool[pid, off]`` in place; an
    int8 pool quantizes each token row and stores its scale.  Duplicate
    (pid, off) pairs only ever target scratch, which is never read
    unmasked."""
    if scale is None:
        pool[pid, off] = rows.to(pool.dtype)
        return
    xq, sc = kops.quantize_activations(
        rows.reshape(rows.shape[:2] + (-1,)).float())
    pool[pid, off] = xq.reshape(rows.shape)
    scale[pid, off] = sc[..., 0]


def pool_view(pool: torch.Tensor, scale: Optional[torch.Tensor],
              table: torch.Tensor, out_dtype) -> torch.Tensor:
    """Gather each slot's pages into the contiguous-equivalent
    (B, max_pages * page_size, feat...) view: fp pools verbatim, int8
    pools dequantized through their per-token scales into ``out_dtype``."""
    g = pool[table]                                 # (B, mp, ps, feat...)
    if scale is not None:
        sc = scale[table].reshape(g.shape[:3] + (1,) * (g.dim() - 3))
        g = (g.float() * sc).to(out_dtype)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


# ---------------------------------------------------------------------------
# A paged pool split over "dp"
# ---------------------------------------------------------------------------
# Each "dp" rank holds one block of ``rows`` pool rows (global pages
# ``first .. first + rows - 1``) while every slot's table row may name any
# page.  The engine builds a ``PageRoute`` on the host from its table
# mirror whenever the tables change (``sharding.page_route``); the model
# reads it in place of the table.  A write is gathered over "dp" and lands
# on the page's owner; a view takes the rank's own pages from its block
# and the pages its slots name elsewhere from one exchange (an all-to-all
# of bytes), and reads scratch as zeros (masked, as unnamed rows are).


class PageRoute(NamedTuple):
    """One rank's routes through a pool split over "dp" (see above)."""
    table: torch.Tensor     # (B, max_pages) global page ids of its slots
    first: int              # its block's first global page
    rows: int               # pages a block
    scratch: int            # the global scratch page
    rows_split: bool        # its slots are its block of the slots
    counts: Tuple           # counts[s][d]: pages rank s sends rank d
    send: torch.Tensor      # (n,) local rows it sends, by destination
    view: torch.Tensor      # (B, max_pages) local row of its own pages
    fix_pos: torch.Tensor   # (m,) flat (b * max_pages + j) other blocks
    fix_src: torch.Tensor   # (m,) their rows in [received | zero page]


def pack_bytes(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` as (its ``lead`` leading dims..., bytes) uint8 (a view of a
    contiguous copy)."""
    t = t.contiguous()
    return t.reshape(t.shape[:lead] + (math.prod(t.shape[lead:]),)).view(
        torch.uint8)


def unpack_bytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    """The ``dtype`` tensor of ``shape`` whose bytes ``b`` holds."""
    return b.contiguous().view(dtype).reshape(shape)


def exchange_rows(tensors, send: torch.Tensor, counts, mesh=None) -> list:
    """Rows ``send`` of each of ``tensors`` (indexed alike on dim 0) to
    the "dp" ranks ``counts`` names (``collectives.exchange`` over
    ``mesh``, the active one by default), in one exchange of their bytes;
    returns each tensor's received rows."""
    got = coll.exchange(torch.cat([pack_bytes(t[send], 1) for t in tensors],
                                  dim=-1), counts, mesh)
    out, col = [], 0
    for t in tensors:
        w = math.prod(t.shape[1:]) * t.element_size()
        out.append(unpack_bytes(got[:, col:col + w], t.dtype,
                                (got.shape[0],) + t.shape[1:]))
        col += w
    return out


def placed_pool_write(pools, route: PageRoute, length: torch.Tensor,
                      S: int) -> None:
    """``pool_write`` on pools split over "dp": ``pools`` are
    [(block, scale block, rows (B, S, feat...))] of one table.  Each rank
    encodes its slots' rows (an int8 pool quantizes each token row, as
    ``pool_write``), the encoded rows and their global write positions are
    gathered over "dp" in one collective, and each rank writes those whose
    page it holds.  A row another rank holds rewrites the first row this
    rank writes with that row's value (or its block's first row with its
    own), so every duplicate write agrees and no host sync is needed."""
    ps = pools[0][0].shape[1]
    pid, off = paged_write_ids(route.table, length, S, ps, route.scratch)
    B = pid.shape[0]
    fields, parts = [], [pack_bytes(pid * ps + off, 2)]
    for pool, scale, rows in pools:
        rows = rows.reshape(B, S, -1)
        if scale is None:
            fields.append(pool)
            parts.append(pack_bytes(rows.to(pool.dtype), 2))
        else:
            xq, sc = kops.quantize_activations(rows.float())
            fields += [pool, scale]
            parts += [pack_bytes(xq, 2), pack_bytes(sc, 2)]
    packed = torch.cat(parts, dim=-1)
    if route.rows_split:
        packed = coll.gather_dp(packed)
    n = packed.shape[0] * S
    packed = packed.reshape(n, -1)
    loc = unpack_bytes(packed[:, :8], torch.int64, (n,)) - route.first * ps
    mine = (loc >= 0) & (loc < route.rows * ps)
    # (1,)-shaped, so that indexing with it is a gather, not a host read
    first = torch.argmax(mine.to(torch.uint8)).view(1)
    any_mine = mine.any()
    tgt = torch.where(mine, loc, torch.where(any_mine, loc[first], 0))
    col = 8
    for t in fields:
        flat = t.view(route.rows * ps, -1)
        width = flat.shape[1] * t.element_size()
        v = unpack_bytes(packed[:, col:col + width], t.dtype, (n, -1))
        keep = torch.where(any_mine, v[first], flat[:1])
        flat[tgt] = torch.where(mine[:, None], v, keep)
        col += width


def placed_pool_view(pools, route: PageRoute, out_dtype) -> list:
    """``pool_view`` on pools split over "dp": ``pools`` are [(block,
    scale block)] of one table.  The pages this rank's slots name and
    another rank holds come in one exchange of every pool's bytes (only
    those pages: ``route.counts``); its own pages come from its block;
    scratch reads as zeros.  Returns each pool's (B, max_pages *
    page_size, feat...) view."""
    fields = [t for pool, scale in pools for t in (pool, scale)
              if t is not None]
    if any(c for row in route.counts for c in row):
        got = exchange_rows(fields, route.send, route.counts)
    else:
        got = [t.new_empty((0,) + t.shape[1:]) for t in fields]
    B, mp = route.view.shape
    views = {}
    for t, r in zip(fields, got):
        g = t[route.view]                          # (B, mp, ps, feat...)
        ext = torch.cat([r, t.new_zeros((1,) + t.shape[1:])])
        g.view((B * mp,) + t.shape[1:])[route.fix_pos] = ext[route.fix_src]
        views[id(t)] = g
    out = []
    for pool, scale in pools:
        g = views[id(pool)]
        if scale is not None:
            sc = views[id(scale)].reshape(g.shape[:3] + (1,) * (g.dim() - 3))
            g = (g.float() * sc).to(out_dtype)
        out.append(g.reshape((B, mp * g.shape[2]) + g.shape[3:]))
    return out


def paged_pools(pools, table, length: torch.Tensor, S: int,
                out_dtype) -> list:
    """Append S rows to each of ``pools`` ([(pool, scale, rows (B, S,
    feat...))] sharing one table) at each slot's fill level, then return
    each pool's contiguous-equivalent view (B, max_pages * page_size,
    feat...).  ``table``: the (B, max_pages) page table, or a
    ``PageRoute`` where the pools are this rank's blocks of pools split
    over "dp"."""
    if isinstance(table, PageRoute):
        placed_pool_write(pools, table, length, S)
        return placed_pool_view([(p, s) for p, s, _ in pools], table,
                                out_dtype)
    pool0 = pools[0][0]
    pid, off = paged_write_ids(table, length, S, pool0.shape[1],
                               pool0.shape[0] - 1)
    for pool, scale, rows in pools:
        pool_write(pool, scale, pid, off, rows)
    return [pool_view(pool, scale, table, out_dtype)
            for pool, scale, _ in pools]


def _span_write(buf: torch.Tensor, rows: torch.Tensor,
                base: torch.Tensor) -> None:
    """``buf[b, base[b] + j] = rows[b, j]`` in place, dropping positions
    past the end of ``buf`` (the reference's scatter ``mode="drop"``):
    clamping would overwrite a slot's last real row.  Dropped rows are sent
    to the last position carrying exactly the value that position ends up
    holding (the last in-bounds row's, or its old value when none is in
    bounds), so the duplicate writes agree and no host sync is needed."""
    B, S = rows.shape[:2]
    s_max = buf.shape[1]
    dev = buf.device
    j = torch.arange(S, device=dev)
    last = s_max - 1 - base.long()                  # row that writes s_max-1
    src = torch.minimum(j[None, :], last[:, None]).clamp(min=0)
    tail = (1,) * (rows.dim() - 2)
    vals = torch.take_along_dim(rows, src.view((B, S) + tail), dim=1)
    vals = torch.where((last < 0).view((B, 1) + tail),
                       buf[:, s_max - 1:], vals.to(buf.dtype))
    tgt = (base.long()[:, None] + j[None, :]).clamp(max=s_max - 1)
    buf[torch.arange(B, device=dev)[:, None], tgt] = vals


class Attention(nn.Module):
    def __init__(self, q, k, v, o, q_norm=None, k_norm=None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("k_norm", k_norm)


def head_block(cfg, cache):
    """(parts, index) of the KV-head block ``cache`` holds on this rank,
    or None when it holds every head (no cache, or no mesh)."""
    if cache is None:
        return None
    return kv_head_block(cfg, (cache.kp if isinstance(cache, PagedKVCache)
                               else cache.k).shape[2])


def kv_head_block(cfg, kh: int):
    """(parts, index) of a block of ``kh`` of the config's KV heads on this
    rank (placed over "model"), or None for every head."""
    if kh == cfg.n_kv_heads:
        return None
    return cfg.n_kv_heads // kh, coll.coordinate(dctx.get_mesh(), "model")


def gqa_attention(p: Attention, x: torch.Tensor, cfg, cache=None,
                  span: bool = False):
    """GQA attention.  Without a cache: causal self-attention.  With one:
    S == 1 appends at each slot's own fill level and attends the whole
    cache (decode); S > 1 appends at the uniform fill level
    ``cache.length[0]`` (prefill into a fresh or uniformly filled cache).

    ``span=True`` (speculative verify, S > 1): the S tokens append at each
    slot's OWN fill level and attention runs decode's masked softmax over
    the whole cache, so a span is the computation of S successive decode
    steps; writes past the cache end are dropped.  A ``PagedKVCache``
    takes decode and span (prefill stays contiguous: the engine page-
    inserts the fragments)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = M.dense(p.q, x).reshape(B, S, H, hd)
    k = M.dense(p.k, x).reshape(B, S, KH, hd)
    v = M.dense(p.v, x).reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = M.rms_norm(p.q_norm, q, cfg.norm_eps)
        k = M.rms_norm(p.k_norm, k, cfg.norm_eps)
    block = head_block(cfg, cache)
    if block is not None:
        parts, r = block
        # under a gradient each rank's q/k/v gradient is its heads' part
        q, k, v = (coll.replicated(t) for t in (q, k, v))
        q = q[:, :, r * H // parts:(r + 1) * H // parts]
        k = k[:, :, r * KH // parts:(r + 1) * KH // parts]
        v = v[:, :, r * KH // parts:(r + 1) * KH // parts]

    dev = x.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    if cache is not None:
        positions = cache.length[:, None].long() + positions
    rot = cfg.rotary_dim or hd
    cos, sin = rope_angles(positions, rot, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    window = getattr(cfg, "attn_window", None)
    if cache is None:
        out = blocked_attention(q, k, v, causal=True, window=window,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
        new_cache = None
    elif isinstance(cache, PagedKVCache):
        if window is not None:
            raise NotImplementedError(
                "paged KV cache does not support attn_window configs")
        if S > 1 and not span:
            raise NotImplementedError(
                "paged caches take no chunked prefill: the engine prefills "
                "contiguous fragments and page-inserts them")
        k_all, v_all = paged_pools(
            [(cache.kp, cache.k_scale, k), (cache.vp, cache.v_scale, v)],
            cache.table, cache.length, S, q.dtype)
        new_len = cache.length + S
        if S == 1:
            out = _decode_attention(q, k_all, v_all, new_len)
        else:
            out = _span_decode_attention(q, k_all, v_all, cache.length)
        new_cache = cache._replace(length=new_len)
    elif window is not None and cache.k.shape[1] <= window:
        # ring cache for sliding-window attention: the cache holds exactly
        # the window, slot = absolute position % W.  Keys are stored
        # post-RoPE, so slot order does not matter to the masked softmax.
        W = cache.k.shape[1]
        if S == 1:
            brange = torch.arange(B, device=dev)
            slot = torch.remainder(cache.length.long(), W)
            cache.k[brange, slot] = k[:, 0].to(cache.k.dtype)
            cache.v[brange, slot] = v[:, 0].to(cache.v.dtype)
            new_len = cache.length + 1
            out = _decode_attention(q, cache.k, cache.v,
                                    torch.clamp(new_len, max=W))
            new_cache = KVCache(cache.k, cache.v, new_len)
        else:
            # single-shot prefill into an empty ring: the last W keys,
            # rolled so that position p sits in slot p % W
            out = blocked_attention(q, k, v, causal=True, window=window,
                                    q_block=cfg.q_block, kv_block=cfg.kv_block)
            if S >= W:
                cache.k.copy_(torch.roll(k[:, S - W:], S % W, dims=1))
                cache.v.copy_(torch.roll(v[:, S - W:], S % W, dims=1))
            else:
                cache.k[:, :S] = k.to(cache.k.dtype)
                cache.v[:, :S] = v.to(cache.v.dtype)
            new_cache = KVCache(cache.k, cache.v, cache.length + S)
    elif S == 1:
        # decode: write at each slot's own fill level.  A free slot's
        # counter keeps growing with the batch; clamping keeps its write in
        # bounds (its row is overwritten whole when the slot is reused).
        brange = torch.arange(B, device=dev)
        idx = cache.length.long().clamp(max=cache.k.shape[1] - 1)
        cache.k[brange, idx] = k[:, 0].to(cache.k.dtype)
        cache.v[brange, idx] = v[:, 0].to(cache.v.dtype)
        new_len = cache.length + 1
        out = _decode_attention(q, cache.k, cache.v, new_len, window)
        new_cache = KVCache(cache.k, cache.v, new_len)
    elif span:
        _span_write(cache.k, k, cache.length)
        _span_write(cache.v, v, cache.length)
        out = _span_decode_attention(q, cache.k, cache.v, cache.length,
                                     window)
        new_cache = KVCache(cache.k, cache.v, cache.length + S)
    else:
        # prefill at the uniform fill level of the batch
        start = cache.length[0].long()
        pos = start + torch.arange(S, device=dev)
        cache.k[:, pos] = k.to(cache.k.dtype)
        cache.v[:, pos] = v.to(cache.v.dtype)
        new_len = cache.length + S
        out = blocked_attention(q, cache.k, cache.v, causal=True,
                                q_offset=start, kv_len=new_len,
                                window=window, q_block=cfg.q_block,
                                kv_block=cfg.kv_block)
        new_cache = KVCache(cache.k, cache.v, new_len)

    if block is not None:
        out = coll.all_gather(out, dim=2)
    out = out.reshape(B, S, H * hd)
    return M.dense(p.o, out), new_cache


def _decode_attention(q, k_cache, v_cache, kv_len, window=None):
    """Single-token decode: q (B,1,H,D) against the whole cache, direct
    masked softmax; kv_len (B,) valid entries per slot, and with
    ``window`` only the last ``window`` of them.  Operands are taken in
    the cache's dtype and multiplied in f32, as the reference's
    f32-accumulating einsum does."""
    return _decode_rows(q, k_cache.float(), v_cache.float(), kv_len,
                        k_cache.dtype, v_cache.dtype, window)


def _decode_rows(q, kf, vf, kv_len, k_dtype, v_dtype, window=None):
    """``_decode_attention`` on the cache already widened to f32 (``kf``,
    ``vf``; ``k_dtype``/``v_dtype`` the cache's own dtypes)."""
    B, _, H, D = q.shape
    _, S, KH, Dv = vf.shape
    G = H // KH
    qh = (q.reshape(B, KH, G, D) * (D ** -0.5)).to(k_dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), kf)
    pos = torch.arange(S, device=q.device)
    lim = kv_len.long()[:, None, None, None]
    mask = pos[None, None, None, :] < lim
    if window is not None:
        mask = mask & (pos[None, None, None, :] > lim - 1 - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", p.to(v_dtype).float(), vf)
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def _span_decode_attention(q, k_cache, v_cache, base_len, window=None):
    """Multi-token decode (speculative verify): q (B,S,H,D) against the
    whole cache; row s of slot b attends positions < base_len[b] + s + 1
    (its own K/V included, as in decode).  The reference batches the S
    rows into one einsum, which XLA reduces exactly as S decode einsums;
    torch's einsum sums in another order at another shape, so the port
    runs decode's own ops row by row (the cache widened to f32 once) and
    the verify's attention is bitwise S successive decode steps'."""
    kf, vf = k_cache.float(), v_cache.float()
    return torch.cat([_decode_rows(q[:, j:j + 1], kf, vf, base_len + j + 1,
                                   k_cache.dtype, v_cache.dtype, window)
                      for j in range(q.shape[1])], dim=1)


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
