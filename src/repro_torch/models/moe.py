"""Mixture-of-Experts MLP with capacity-bounded, shape-static dispatch
(port of ``repro.models.moe``).

Tokens are split into ``moe_groups`` groups; within a group, top-k
assignments get positions through a cumsum over a (Tg*k, E) one-hot,
assignments past the expert capacity are dropped, and dispatch is a take
into (G, E, cap, D) with a zero sentinel token.  The expert FFNs are
einsums over the dequantized (E, in, out) weights, as in the reference
(XLA there, torch here: no hand-written kernel); the shared experts are a
SwiGLU whose quantized matmuls run K1.

Departures from the reference, each deliberate:

  * ``dctx.constrain`` (the reference's sharding hints) has no meaning on
    one device and is left out;
  * top-k is a stable descending sort, so ties pick the lower expert index
    first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order);
  * the combine gathers each token's k gated slots and sums them in k
    order from zero: the reference's scatter-add order, deterministic on
    the card where ``index_add_`` uses atomics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from . import modules as M


class MoE(nn.Module):
    """``router`` (f32 Dense, never quantized); ``w_gate``/``w_up``
    (E, D, F) and ``w_down`` (E, F, D) expert stacks held as ``Dense``
    kernels (a tensor, or a CLAQ tensor / plan stacked on E in paper
    layout); ``shared`` the shared experts' SwiGLU or None."""

    def __init__(self, router: M.Dense, w_gate: M.Dense, w_up: M.Dense,
                 w_down: M.Dense, shared: Optional[L.SwiGLU] = None):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
        self.shared = shared


def expert_weight(w: M.Dense, dtype) -> torch.Tensor:
    """(E, in, out) expert weights in ``dtype``.  A quantized stack (paper
    layout (E, out, in)) is dequantized in one batched pass and viewed
    swapped back, as the reference's vmapped dequantize + swapaxes."""
    k = w.kernel
    if isinstance(k, M._QUANTIZED):
        return k.dequantize(dtype).transpose(1, 2)
    return k.to(dtype)


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32,
             device=None) -> MoE:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    router = M.dense_init(gen, D, E, dtype=torch.float32, device=device)
    w_gate = M.Dense(normal((E, D, F_), D ** -0.5))
    w_up = M.Dense(normal((E, D, F_), D ** -0.5))
    w_down = M.Dense(normal((E, F_, D), F_ ** -0.5))
    shared = None
    if cfg.n_shared_experts > 0:
        shared = L.swiglu_init(gen, D, F_ * cfg.n_shared_experts, dtype,
                               device)
    return MoE(router, w_gate, w_up, w_down, shared)


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (a
    stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tg: int, cfg) -> int:
    """Slots per expert and group: ceil(Tg k / E) scaled by the capacity
    factor, at least 1."""
    slots = -(-tg * cfg.top_k // cfg.n_experts) * cfg.capacity_factor
    return max(int(slots), 1)  # contract: ok — host numbers, not a tensor


def moe_mlp(p: MoE, x: torch.Tensor, cfg, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux loss).  Routing is per token, top_k experts.
    ``stats`` (a dict), when given, gets ``dropped``: the (device) count of
    assignments past capacity."""
    B, S, D = x.shape
    E, K, G = cfg.n_experts, cfg.top_k, cfg.moe_groups
    T = B * S
    assert T % G == 0, (T, G)
    Tg = T // G
    cap = capacity(Tg, cfg)
    dev = x.device
    xf = x.reshape(G, Tg, D)

    logits = M.dense(p.router, xf.float())                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                   # (G, Tg, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- positions within each expert (group-local cumsum) ----------------
    flat_e = gate_idx.reshape(G, Tg * K)                    # assignment -> e
    experts = torch.arange(E, device=dev)
    # one-hot by comparison: F.one_hot reads the index range back to the
    # host (two syncs a call)
    onehot = (flat_e[..., None] == experts).to(torch.int32)  # (G, Tg*K, E)
    pos_all = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0]
    keep = pos < cap                                        # not dropped
    if stats is not None:
        stats["dropped"] = (~keep).sum()

    # ---- dispatch: (G, E, cap) slot -> source token -------------------------
    tok_ids = torch.arange(Tg, device=dev)[None, :, None].expand(
        G, Tg, K).reshape(G, Tg * K)
    slot = torch.where(keep, flat_e * cap + pos, E * cap)   # dropped: sentinel
    d_tok = torch.full((G, E * cap + 1), Tg, dtype=torch.long, device=dev)
    d_tok.scatter_(1, slot, tok_ids)     # kept slots are unique
    d_tok = d_tok[:, :E * cap]
    x_pad = torch.cat([xf, torch.zeros((G, 1, D), dtype=xf.dtype,
                                       device=dev)], dim=1)
    dispatched = torch.gather(x_pad, 1, d_tok[..., None].expand(
        G, E * cap, D)).reshape(G, E, cap, D)

    # ---- expert FFN ---------------------------------------------------------
    M.record_expert_inputs(p, "expert_in", dispatched)
    h_g = torch.einsum("gecd,edf->gecf", dispatched,
                       expert_weight(p.w_gate, x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", dispatched,
                       expert_weight(p.w_up, x.dtype))
    h = F.silu(h_g) * h_u
    M.record_expert_inputs(p, "expert_mid", h)
    out = torch.einsum("gecf,efd->gecd", h, expert_weight(p.w_down, x.dtype))

    # ---- combine: each token's k gated slots, summed in k order -------------
    gates_flat = torch.where(keep, gate_vals.reshape(G, Tg * K), 0.0)
    out_flat = out.reshape(G, E * cap, D)
    src = torch.gather(out_flat, 1, torch.clamp(slot, max=E * cap - 1)[
        ..., None].expand(G, Tg * K, D))
    src = src * gates_flat[..., None].to(out.dtype)
    src = torch.where(keep[..., None], src, 0.0).reshape(G, Tg, K, D)
    y = torch.zeros((G, Tg, D), dtype=out.dtype, device=dev)
    for j in range(K):
        y = y + src[:, :, j]
    y = y.reshape(B, S, D)

    # ---- shared experts + aux loss ------------------------------------------
    if p.shared is not None:
        y = y + L.swiglu_mlp(p.shared, x)
    # load-balance loss (Switch): E * sum_e f_e * p_e
    frac_tokens = torch.mean((gate_idx[..., None] == experts).float(),
                             dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.to(x.dtype), aux
