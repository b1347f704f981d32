"""Mamba2 block (port of ``repro.models.mamba2``): SSD (state-space
duality) with a chunked parallel scan.

Train and prefill run the chunked SSD form (an attention-like term inside
each chunk and a state recurrence across chunks, a Python loop where the
reference scans); decode is the O(1) recurrent update.  d_inner =
expand * d_model, heads H = d_inner / headdim P, state N.

Two details follow the reference exactly: the intra-chunk decay mask is
applied BEFORE the exp, with -1e30; and the operands the reference casts
to the activation dtype (``w_ts``, ``sdecay``, ``exp(cum)``, ``S_in``) are
rounded to it, then widened to f32 and summed in f32 — its
``preferred_element_type`` einsums (a torch einsum of bf16 operands would
sum in bf16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import modules as M


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, conv_w - 1, conv_dim) last causal-conv inputs
    ssm: torch.Tensor      # (B, H, P, N) f32 state
    length: torch.Tensor   # (B,) int32


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, d_inner + 2 * cfg.ssm_state


def init_mamba_cache(batch: int, cfg, dtype=torch.bfloat16,
                     device=None) -> MambaCache:
    d_inner, H, conv_dim = mamba_dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


class Mamba(nn.Module):
    def __init__(self, in_proj, conv_w, conv_b, a_log, dt_bias, d_skip, norm,
                 out_proj):
        super().__init__()
        self.in_proj = in_proj
        self.register_buffer("conv_w", conv_w)      # (K, conv_dim)
        self.register_buffer("conv_b", conv_b)      # (conv_dim,)
        self.register_buffer("a_log", a_log)        # (H,) f32
        self.register_buffer("dt_bias", dt_bias)    # (H,) f32
        self.register_buffer("d_skip", d_skip)      # (H,) f32
        self.register_buffer("norm", norm)          # (d_inner,) rms scale
        self.out_proj = out_proj


def mamba_init(gen: torch.Generator, cfg, dtype=torch.float32,
               device=None) -> Mamba:
    D = cfg.d_model
    d_inner, H, conv_dim = mamba_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = M.dense_init(gen, D, 2 * d_inner + 2 * cfg.ssm_state + H, **kw)
    conv_w = (torch.randn((cfg.ssm_conv, conv_dim), generator=gen, **f32)
              * 0.2).to(dtype)
    return Mamba(in_proj, conv_w, torch.zeros((conv_dim,), **kw),
                 torch.log(torch.linspace(1.0, 16.0, H, **f32)),
                 torch.zeros((H,), **f32), torch.ones((H,), **f32),
                 M.norm_scale_init(d_inner, dtype, device),
                 M.dense_init(gen, d_inner, D, **kw))


def _conv_apply(w: torch.Tensor, b: torch.Tensor, seq: torch.Tensor):
    """Causal depthwise conv along time; ``seq`` (B, T + K - 1, C) is
    already left-padded, w (K, C), b (C,)."""
    w = w.to(seq.dtype)
    K, L = w.shape[0], seq.shape[1]
    out = seq[:, 0:L - (K - 1)] * w[0][None, None, :]
    for i in range(1, K):
        out = out + seq[:, i:L - (K - 1) + i] * w[i][None, None, :]
    return out + b.to(seq.dtype)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD.  x (B, T, H, P); dt (B, T, H) f32; A (H,); Bm/Cm
    (B, T, N).  Returns (y (B, T, H, P) f32, final state (B, H, P, N)).
    Recurrence: S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T; y_t = S_t C_t."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bm, Cm))
    Tp = T + pad
    nc = Tp // chunk
    act = x.dtype

    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    dA = dtc * A[None, None, None, :]                  # (B, nc, l, H)
    cum = torch.cumsum(dA, dim=2)                      # inclusive
    total = cum[:, :, -1:, :]                          # (B, nc, 1, H)

    # intra-chunk: y_t += sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t.B_s) x_s
    # (masked BEFORE the exp: a masked ratio is > 0 and would overflow)
    ratio = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ratio = torch.where(tri[None, None, :, :, None], ratio, -1e30)
    decay = torch.exp(ratio)
    cb = torch.einsum("bctn,bcsn->bcts", Cc.float(), Bc.float())
    w_ts = (cb[..., None] * decay * dtc[:, :, None, :, :]).to(act)
    y = torch.einsum("bctsh,bcshp->bcthp", w_ts.float(), xc.float())

    # chunk -> state contribution: sum_s exp(total - cum_s) dt_s B_s x_s^T
    sdecay = (torch.exp(total - cum) * dtc).to(act)    # (B, nc, l, H)
    chunk_state = torch.einsum("bcsh,bcsn,bcshp->bchpn", sdecay.float(),
                               Bc.float(), xc.float())

    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    s_in = []
    for c in range(nc):                                # the reference's scan
        s_in.append(S)
        S = S * torch.exp(total[:, c, 0])[:, :, None, None] + chunk_state[:, c]
    S_in = torch.stack(s_in, dim=1)                    # (B, nc, H, P, N)

    # carried-state term: y_t += exp(cum_t) C_t . S_in
    y = y + torch.einsum("bclh,bcln,bchpn->bclhp",
                         torch.exp(cum).to(act).float(), Cc.float(),
                         S_in.to(act).float())
    return y.reshape(Bsz, Tp, H, P)[:, :T], S


def mamba_block(p: Mamba, x: torch.Tensor, cfg,
                cache: Optional[MambaCache] = None):
    """x (B, T, D) -> (out (B, T, D), new MambaCache or None)."""
    B, T, D = x.shape
    d_inner, H, conv_dim = mamba_dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state

    zxbcdt = M.dense(p.in_proj, x)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]

    if cache is not None:
        left = cache.conv.to(xbc.dtype)
    else:
        left = torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=xbc.dtype,
                           device=x.device)
    seq = torch.cat([left, xbc], dim=1)
    new_conv = seq[:, -(cfg.ssm_conv - 1):] if cfg.ssm_conv > 1 else left
    # depthwise: the reference convolves the x | B | C segments apart,
    # which is the same per-channel arithmetic
    conv = F.silu(_conv_apply(p.conv_w, p.conv_b, seq))
    xs = conv[..., :d_inner].reshape(B, T, H, P)
    Bm = conv[..., d_inner:d_inner + N]
    Cm = conv[..., d_inner + N:]

    dtv = dt_raw.float() + p.dt_bias[None, None, :]
    dt = torch.logaddexp(dtv, torch.zeros_like(dtv))   # jax.nn.softplus
    A = -torch.exp(p.a_log)

    if cache is not None and T == 1:
        S = cache.ssm
        dA = torch.exp(dt[:, 0] * A[None, :])          # (B, H)
        dx = dt[:, 0, :, None] * xs[:, 0].float()      # (B, H, P)
        S = (S * dA[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", dx, Bm[:, 0].float()))
        y = torch.einsum("bhpn,bn->bhp", S, Cm[:, 0].float())[:, None]
        final = S
    else:
        y, final = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                                cache.ssm if cache is not None else None)

    y = y + p.d_skip[None, None, :, None] * xs.float()
    y = y.reshape(B, T, d_inner).to(x.dtype)
    y = M.rms_norm(p.norm, y * F.silu(z), cfg.norm_eps)
    out = M.dense(p.out_proj, y)

    new_cache = None
    if cache is not None:
        new_cache = MambaCache(conv=new_conv.to(cache.conv.dtype), ssm=final,
                               length=cache.length + T)
    return out, new_cache
