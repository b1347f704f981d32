"""RWKV6 ("Finch") block (port of ``repro.models.rwkv6``): time-mix with
data-dependent per-channel decay and a squared-ReLU channel-mix.

Train and prefill run the GLA-style chunked form of the WKV recurrence
(log-space decay ratios inside a chunk, the state carried across chunks
by a Python loop where the reference scans); decode is the exact O(1)
recurrence.  Per head, key and value dim N:

    out_t = r_t . (S_{t-1} + (u ∘ k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(wlog_t))

The chunk form multiplies by ``exp(-cw)``, which inside a 64-token chunk
reaches about e^23.5 at init decays; it keeps the reference's f32 order of
operations, unchanged.  The recurrent state leaves are returned as new
tensors (a state is (B, H, N, N) f32, small beside a KV cache).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import modules as M


class RWKVCache(NamedTuple):
    state: torch.Tensor     # (B, H, N, N) f32 wkv state
    prev_tm: torch.Tensor   # (B, D) last input of time-mix (token shift)
    prev_cm: torch.Tensor   # (B, D) last input of channel-mix
    length: torch.Tensor    # (B,) int32


def rwkv_dims(cfg):
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def init_rwkv_cache(batch: int, cfg, dtype=torch.bfloat16,
                    device=None) -> RWKVCache:
    H, N = rwkv_dims(cfg)
    return RWKVCache(
        state=torch.zeros((batch, H, N, N), dtype=torch.float32,
                          device=device),
        prev_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        prev_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


class TimeMix(nn.Module):
    def __init__(self, mix, r, k, v, g, w_lora_a, w_lora_b, w_bias, u_bonus,
                 ln_x_scale, ln_x_bias, o):
        super().__init__()
        self.register_buffer("mix", mix)            # (5, D) f32: r,k,v,g,w
        self.r, self.k, self.v, self.g = r, k, v, g
        self.w_lora_a, self.w_lora_b = w_lora_a, w_lora_b
        self.register_buffer("w_bias", w_bias)      # (D,) f32
        self.register_buffer("u_bonus", u_bonus)    # (H, N) f32
        self.register_buffer("ln_x_scale", ln_x_scale)
        self.register_buffer("ln_x_bias", ln_x_bias)
        self.o = o


class ChannelMix(nn.Module):
    def __init__(self, mix, k, v, r):
        super().__init__()
        self.register_buffer("mix", mix)            # (2, D) f32: k, r
        self.k, self.v, self.r = k, v, r


def rwkv_init(gen: torch.Generator, cfg, dtype=torch.float32,
              device=None):
    """(TimeMix, ChannelMix) at the reference's init values."""
    D = cfg.d_model
    H, N = rwkv_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    tm = TimeMix(
        0.5 * torch.ones((5, D), **f32),
        M.dense_init(gen, D, D, **kw), M.dense_init(gen, D, D, **kw),
        M.dense_init(gen, D, D, **kw), M.dense_init(gen, D, D, **kw),
        M.dense_init(gen, D, cfg.decay_lora, **kw),
        M.dense_init(gen, cfg.decay_lora, D, scale=0.01, **kw),
        torch.full((D,), -1.0, **f32), torch.zeros((H, N), **f32),
        torch.ones((D,), **f32), torch.zeros((D,), **f32),
        M.dense_init(gen, D, D, **kw))
    cm = ChannelMix(0.5 * torch.ones((2, D), **f32),
                    M.dense_init(gen, D, cfg.d_ff, **kw),
                    M.dense_init(gen, cfg.d_ff, D, **kw),
                    M.dense_init(gen, D, D, **kw))
    return tm, cm


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """shifted_t = x_{t-1} (``prev`` for t = 0; zeros without it)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, chunk: int, init_state=None):
    """Chunked WKV.  r, k, v (B, T, H, N); logw (B, T, H, N) the log decay
    (< 0); u (H, N).  Returns (out (B, T, H, N) f32, final state
    (B, H, N, N) f32)."""
    B, T, H, N = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    Tp = T + pad
    nc = Tp // chunk
    shp = (B, nc, chunk, H, N)
    rc, kc, vc, lw = (a.reshape(shp).float() for a in (r, k, v, logw))

    cw = torch.cumsum(lw, dim=2)                       # inclusive cumsum
    cw_prev = cw - lw                                  # exclusive
    total = cw[:, :, -1]                               # (B, nc, H, N)

    # intra-chunk: out_t += sum_{s<t} (r_t ∘ e^{cwprev_t - cw_s}).k_s v_s
    r_t = rc * torch.exp(cw_prev)
    k_s = kc * torch.exp(-cw)
    att = torch.einsum("bcthn,bcshn->bchts", r_t, k_s)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    att = torch.where(tri, att, 0.0)
    out = torch.einsum("bchts,bcshn->bcthn", att, vc)
    # diagonal bonus term: (r_t ∘ u ∘ k_t) . v_t
    diag = (rc * u.float() * kc).sum(dim=-1)
    out = out + diag[..., None] * vc

    # chunk state contribution: sum_s (k_s ∘ e^{total - cw_s}) v_s^T
    k_dec = kc * torch.exp(total[:, :, None] - cw)
    chunk_state = torch.einsum("bcshn,bcshm->bchnm", k_dec, vc)

    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if init_state is None else init_state)
    s_in = []
    for c in range(nc):                                # the reference's scan
        s_in.append(S)
        S = S * torch.exp(total[:, c])[..., None] + chunk_state[:, c]
    S_in = torch.stack(s_in, dim=1)                    # (B, nc, H, N, N)

    # carried-state term: out_t += (r_t ∘ e^{cwprev_t}) . S_in
    out = out + torch.einsum("bcthn,bchnm->bcthm", r_t, S_in)
    return out.reshape(B, Tp, H, N)[:, :T], S


def time_mix(p: TimeMix, x: torch.Tensor, cfg,
             cache: Optional[RWKVCache] = None):
    """Returns (y (B, T, D), final wkv state, x's last row)."""
    B, T, D = x.shape
    H, N = rwkv_dims(cfg)
    xs = _token_shift(x, cache.prev_tm if cache is not None else None)

    def mixed(i):
        m = p.mix[i][None, None, :].to(x.dtype)
        return x * m + xs * (1.0 - m)

    r = M.dense(p.r, mixed(0)).reshape(B, T, H, N)
    k = M.dense(p.k, mixed(1)).reshape(B, T, H, N)
    v = M.dense(p.v, mixed(2)).reshape(B, T, H, N)
    g = M.dense(p.g, mixed(3))
    wlog = (p.w_bias[None, None, :].float()
            + M.dense(p.w_lora_b,
                      torch.tanh(M.dense(p.w_lora_a, mixed(4)))).float())
    logw = -torch.exp(wlog).reshape(B, T, H, N)        # log decay, < 0

    if cache is not None and T == 1:
        S = cache.state
        r1, k1, v1 = (a[:, 0].float() for a in (r, k, v))
        u = p.u_bonus.float()
        out = (torch.einsum("bhn,bhnm->bhm", r1, S)
               + (r1 * u * k1).sum(dim=-1)[..., None] * v1)
        S = (S * torch.exp(logw[:, 0])[..., None]
             + torch.einsum("bhn,bhm->bhnm", k1, v1))
        out = out[:, None]
        final = S
    else:
        out, final = _wkv_chunked(r, k, v, logw, p.u_bonus, cfg.rwkv_chunk,
                                  cache.state if cache is not None else None)

    out = out.reshape(B, T, D).to(x.dtype)
    out = M.layer_norm(p.ln_x_scale, p.ln_x_bias, out)
    out = out * F.silu(g)
    return M.dense(p.o, out), final, x[:, -1]


def channel_mix(p: ChannelMix, x: torch.Tensor,
                cache: Optional[RWKVCache] = None):
    """Returns (y (B, T, D), x's last row)."""
    xs = _token_shift(x, cache.prev_cm if cache is not None else None)
    mk, mr = p.mix[0][None, None], p.mix[1][None, None]
    xk = x * mk.to(x.dtype) + xs * (1 - mk).to(x.dtype)
    xr = x * mr.to(x.dtype) + xs * (1 - mr).to(x.dtype)
    k = torch.square(F.relu(M.dense(p.k, xk)))
    y = torch.sigmoid(M.dense(p.r, xr)) * M.dense(p.v, k)
    return y, x[:, -1]
