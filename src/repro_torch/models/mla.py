"""Multi-head Latent Attention (DeepSeek-V2) with a compressed-KV cache
(port of ``repro.models.mla``).

Train/prefill: full expansion (q through its low-rank down/up, k/v
expanded from the shared latent) over the whole cache, through
``layers.blocked_attention``.  Decode: the *absorbed* form, scores taken
directly against the latent cache (c_kv, k_pe), so a token costs
kv_lora + rope_head_dim cache entries (576 for the 236B config) instead
of 2 * H * head_dim.  Caches are updated in place, as ``layers`` does.

Span decode (speculative verify) runs the absorbed decode's einsums row
by row, so on the CPU a verify is bitwise S successive absorbed decodes
(as ``layers._span_decode_attention``).

``dctx.constrain`` (the reference's sharding hints) has no counterpart.
On a mesh, attention is head-parallel over "model" where
``dist.sharding.place_model`` placed ``kv_up`` (its out dim, whole heads:
a CLAQ plan's N block, a dense kernel's column block): the rank takes its
heads of the replicated q, runs the absorbed decode and span on its own
rows of ``kv_up`` (expanded prefill and training on its heads of the
replicated K/V), and the heads are all-gathered before ``o``, as
``layers.gqa_attention`` does.  Where ``kv_up`` stays whole every rank
runs every head.  The latent caches are whole on every model rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.dist import collectives as coll

from . import layers as L
from . import modules as M


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S_max, kv_lora)
    k_pe: torch.Tensor     # (B, S_max, rope_head_dim)
    length: torch.Tensor   # (B,) int32


def init_mla_cache(batch: int, max_len: int, cfg, dtype=torch.bfloat16,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                         device=device),
        k_pe=torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype,
                         device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


class PagedMLACache(NamedTuple):
    """Paged compressed-KV cache: the pool/table/scratch contract of
    ``layers.PagedKVCache`` with rank-3 pools for the latent strips."""
    cp: torch.Tensor                 # (n_pages+1, page_size, kv_lora)
    pp: torch.Tensor                 # (n_pages+1, page_size, rope_head_dim)
    c_scale: Optional[torch.Tensor]  # (n_pages+1, page_size) f32 iff int8
    p_scale: Optional[torch.Tensor]
    table: torch.Tensor              # (B, max_pages) int64
    length: torch.Tensor             # (B,) int32


def init_paged_mla_cache(batch: int, max_len: int, cfg, *, page_size: int,
                         n_pages: int, dtype=torch.bfloat16, kv_dtype=None,
                         device=None, table: Optional[torch.Tensor] = None
                         ) -> PagedMLACache:
    if max_len % page_size:
        raise ValueError(
            f"page_size {page_size} must divide max_len {max_len}")
    int8 = kv_dtype == "int8"
    pool_dtype = torch.int8 if int8 else dtype

    def scale():
        return (torch.zeros((n_pages + 1, page_size), dtype=torch.float32,
                            device=device) if int8 else None)

    if table is None:
        table = torch.full((batch, max_len // page_size), n_pages,
                           dtype=torch.long, device=device)
    return PagedMLACache(
        cp=torch.zeros((n_pages + 1, page_size, cfg.kv_lora),
                       dtype=pool_dtype, device=device),
        pp=torch.zeros((n_pages + 1, page_size, cfg.rope_head_dim),
                       dtype=pool_dtype, device=device),
        c_scale=scale(), p_scale=scale(), table=table,
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


class MLA(nn.Module):
    def __init__(self, q_down, q_norm, q_up, kv_down, kv_norm, kv_up, o):
        super().__init__()
        self.q_down, self.q_up = q_down, q_up
        self.kv_down, self.kv_up, self.o = kv_down, kv_up, o
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("kv_norm", kv_norm)


def mla_init(gen: torch.Generator, cfg, dtype=torch.float32,
             device=None) -> MLA:
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return MLA(
        q_down=M.dense_init(gen, D, cfg.q_lora, **kw),
        q_norm=M.norm_scale_init(cfg.q_lora, dtype, device),
        q_up=M.dense_init(gen, cfg.q_lora, H * (dn + dr), **kw),
        kv_down=M.dense_init(gen, D, cfg.kv_lora + dr, **kw),
        kv_norm=M.norm_scale_init(cfg.kv_lora, dtype, device),
        kv_up=M.dense_init(gen, cfg.kv_lora, H * (dn + dv), **kw),
        o=M.dense_init(gen, H * dv, D, **kw))


def _project_q(p: MLA, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    cq = M.rms_norm(p.q_norm, M.dense(p.q_down, x), cfg.norm_eps)
    q = M.dense(p.q_up, cq).reshape(B, S, H, dn + dr)
    cos, sin = L.rope_angles(positions, dr, cfg.rope_theta)
    return q[..., :dn], L.apply_rope(q[..., dn:], cos, sin)


def _latent_kv(p: MLA, x, cfg, positions):
    ckv_full = M.dense(p.kv_down, x)
    c_kv = M.rms_norm(p.kv_norm, ckv_full[..., :cfg.kv_lora], cfg.norm_eps)
    cos, sin = L.rope_angles(positions, cfg.rope_head_dim, cfg.rope_theta)
    k_pe = L.apply_rope(ckv_full[..., cfg.kv_lora:][:, :, None, :], cos,
                        sin)[:, :, 0, :]
    return c_kv, k_pe


def mla_attention(p: MLA, x: torch.Tensor, cfg, cache=None,
                  span: bool = False):
    """MLA attention.  Without a cache: causal self-attention, expanded.
    With one: S == 1 appends at each slot's own fill level and runs the
    absorbed decode; ``span`` appends S latents at each slot's own level
    (writes past the end dropped) and runs the absorbed span; otherwise
    (prefill, chunked prefill) the S latents append at the uniform fill
    level ``cache.length[0]`` and the expanded path attends the whole
    cache.  A ``PagedMLACache`` takes decode and span only."""
    B, S, _ = x.shape
    H, dv = cfg.n_heads, cfg.v_head_dim
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    if cache is not None:
        positions = cache.length[:, None].long() + positions
    q_nope, q_pe = _project_q(p, x, cfg, positions)
    c_kv, k_pe = _latent_kv(p, x, cfg, positions)
    heads = head_block(p, cfg)
    if heads is not None:
        # under a gradient each rank's q gradient is its heads' part
        q_nope, q_pe = (coll.replicated(t)[:, :, heads] for t in (q_nope,
                                                                  q_pe))

    if cache is None:
        out = _expanded(p, q_nope, q_pe, c_kv, k_pe, cfg, 0, None, heads)
        return _output(p, out, heads, B, S, H * dv), None
    new_len = cache.length + S
    if isinstance(cache, PagedMLACache):
        if S > 1 and not span:
            raise NotImplementedError(
                "paged caches take no chunked prefill: the engine prefills "
                "contiguous fragments and page-inserts them")
        c_all, pe_all = L.paged_pools(
            [(cache.cp, cache.c_scale, c_kv), (cache.pp, cache.p_scale,
                                               k_pe)],
            cache.table, cache.length, S, x.dtype)
        new_cache = cache._replace(length=new_len)
        if S == 1:
            out = _absorbed_decode(p, q_nope, q_pe, c_all, pe_all, new_len,
                                   cfg)
        else:
            out = _absorbed_span(p, q_nope, q_pe, c_all, pe_all,
                                 cache.length, cfg)
    elif S == 1:
        # a free slot's counter keeps growing with the batch; clamping
        # keeps its write in bounds (as layers.gqa_attention)
        brange = torch.arange(B, device=dev)
        idx = cache.length.long().clamp(max=cache.c_kv.shape[1] - 1)
        cache.c_kv[brange, idx] = c_kv[:, 0].to(cache.c_kv.dtype)
        cache.k_pe[brange, idx] = k_pe[:, 0].to(cache.k_pe.dtype)
        new_cache = MLACache(cache.c_kv, cache.k_pe, new_len)
        out = _absorbed_decode(p, q_nope, q_pe, cache.c_kv, cache.k_pe,
                               new_len, cfg)
    elif span:
        L._span_write(cache.c_kv, c_kv, cache.length)
        L._span_write(cache.k_pe, k_pe, cache.length)
        new_cache = MLACache(cache.c_kv, cache.k_pe, new_len)
        out = _absorbed_span(p, q_nope, q_pe, cache.c_kv, cache.k_pe,
                             cache.length, cfg)
    else:
        start = cache.length[0].long()
        pos = start + torch.arange(S, device=dev)
        cache.c_kv[:, pos] = c_kv.to(cache.c_kv.dtype)
        cache.k_pe[:, pos] = k_pe.to(cache.k_pe.dtype)
        new_cache = MLACache(cache.c_kv, cache.k_pe, new_len)
        out = _expanded(p, q_nope, q_pe, cache.c_kv, cache.k_pe, cfg, start,
                        new_len, heads)
    return _output(p, out, heads, B, S, H * dv), new_cache


def head_block(p: MLA, cfg) -> Optional[slice]:
    """This rank's heads where ``kv_up`` is placed over "model" (its out
    block, which must be whole heads), else None (every head)."""
    blk = M.out_block(p.kv_up.kernel)
    if blk is None:
        return None
    width = cfg.head_dim + cfg.v_head_dim
    n = blk.width
    if n * blk.parts != blk.total or n % width:
        raise NotImplementedError(
            f"kv_up's placed block of {n} rows is not whole heads of "
            f"{width}: place it on a model axis that divides the heads")
    return slice(blk.index * n // width, (blk.index + 1) * n // width)


def _output(p: MLA, out, heads, B, S, width):
    """``o`` over the attention output (B, S, heads, dv), its heads
    all-gathered over "model" first when this rank ran its own."""
    if heads is not None:
        out = coll.all_gather(out, dim=2)
    return M.dense(p.o, out.reshape(B, S, width))


def _expanded(p: MLA, q_nope, q_pe, c_kv, k_pe, cfg, q_off, kv_len,
              heads=None):
    """The train/prefill path: K/V expanded from every latent row given
    (the whole cache at prefill, as the reference does), then blocked
    causal attention (over this rank's ``heads`` of the replicated K/V on
    a mesh)."""
    B, Skv, _ = c_kv.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    dt = q_nope.dtype
    kv = M.dense(p.kv_up, c_kv.to(dt)).reshape(B, Skv, H, dn + dv)
    if heads is not None:
        # every head reads k_pe: a rank's gradient is its heads' part
        kv = coll.replicated(kv)[:, :, heads]
        k_pe = coll.replicated(k_pe)
    H = kv.shape[2]
    k = torch.cat([kv[..., :dn], k_pe[:, :, None, :].to(dt).expand(
        B, Skv, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    return L.blocked_attention(q, k, kv[..., dn:], causal=True,
                               q_offset=q_off, kv_len=kv_len,
                               q_block=cfg.q_block, kv_block=cfg.kv_block)


def _absorbed_weights(p: MLA, cfg):
    """(w_uk (kv_lora, H, dn), w_uv (kv_lora, H, dv)) from ``kv_up``
    (dequantized to bf16 when quantized, as in the reference); a placed
    ``kv_up`` gives this rank's heads."""
    dn = cfg.head_dim
    kv_up = M.materialize_kernel(p.kv_up).reshape(cfg.kv_lora, -1,
                                                  dn + cfg.v_head_dim)
    return kv_up[..., :dn], kv_up[..., dn:]


def _absorbed_rows(q_nope, q_pe, c_all, cf, pe_all, pf, kv_len, w_uk, w_uv,
                   cfg):
    """One absorbed decode row per slot: q (B, 1, H, ·) against the latent
    cache (``cf``/``pf``: c_all/pe_all widened to f32; operands are taken
    in the reference's dtypes and multiplied in f32, as its f32-
    accumulating einsums)."""
    B = q_nope.shape[0]
    scale = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    qf = q_nope[:, 0]
    q_abs = torch.einsum("bhd,lhd->bhl", qf.float(),
                         w_uk.to(qf.dtype).float())
    s = torch.einsum("bhl,bsl->bhs", q_abs.to(c_all.dtype).float(), cf)
    s = s + torch.einsum("bhr,bsr->bhs",
                         q_pe[:, 0].to(pe_all.dtype).float(), pf)
    s = s * scale
    lim = torch.as_tensor(kv_len, device=q_nope.device).expand(B)
    mask = (torch.arange(c_all.shape[1], device=q_nope.device)[None, None, :]
            < lim.long()[:, None, None])
    prob = torch.softmax(torch.where(mask, s, L.NEG_INF), dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", prob.to(c_all.dtype).float(), cf)
    out = torch.einsum("bhl,lhv->bhv", ctx.to(w_uv.dtype).float(),
                       w_uv.float())
    return out[:, None].to(q_nope.dtype)                  # (B, 1, H, dv)


def _absorbed_decode(p: MLA, q_nope, q_pe, c_all, pe_all, kv_len, cfg):
    """Decode against the latent cache without expanding K/V:
    score(s) = (W_uk^T q_nope) . c_s + q_pe . k_pe_s, and the context
    taken back through W_uv."""
    w_uk, w_uv = _absorbed_weights(p, cfg)
    return _absorbed_rows(q_nope, q_pe, c_all, c_all.float(), pe_all,
                          pe_all.float(), kv_len, w_uk, w_uv, cfg)


def _absorbed_span(p: MLA, q_nope, q_pe, c_all, pe_all, base_len, cfg):
    """``_absorbed_decode`` over a span: row s of slot b attends latents at
    positions < base_len[b] + s + 1.  The reference batches the rows into
    one einsum, which XLA reduces as the decode's; torch's einsum sums in
    another order at another shape, so the port runs the decode's own ops
    row by row (weights and the widened cache made once)."""
    w_uk, w_uv = _absorbed_weights(p, cfg)
    cf, pf = c_all.float(), pe_all.float()
    return torch.cat([_absorbed_rows(q_nope[:, j:j + 1], q_pe[:, j:j + 1],
                                     c_all, cf, pe_all, pf,
                                     base_len + j + 1, w_uk, w_uv, cfg)
                      for j in range(q_nope.shape[1])], dim=1)
