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

  * ``dctx.constrain`` (the reference's sharding hints) has no
    counterpart: on a mesh the placement is explicit (below);
  * top-k is a stable descending sort, so ties pick the lower expert index
    first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order);
  * the combine gathers each token's k gated slots and sums them in k
    order from zero: the reference's scatter-add order, deterministic on
    the card where ``index_add_`` uses atomics.

On a (data, model) mesh.  ``dist.sharding.place_model`` splits an expert
stack on its out dim over "model" (a CLAQ stack along N into whole tiles,
a dense (E, in, out) stack on ``out``; never E, never a contraction dim),
or keeps it whole.  A placed stack dequantizes only its own rows, and
each expert product's out block is all-gathered over "model" before the
next product reads it (gate and up: their SwiGLU product once).  The
reference routes the global batch in ``cfg.moe_groups`` groups, so where
the rows are this data rank's block (``dctx.rows_split``: a decode step,
a train step) the port routes the same problem: locally when the rank's
rows are whole groups (``moe_groups`` a multiple of the data size), the
aux loss's two means averaged over "dp" before their product; otherwise
it all-gathers the rows over "dp", routes every row and keeps its own,
the gather's backward summing over "dp".  A caller that never reads the
aux loss (a cached forward: serving, the dry run's decode) asks for none
and spends no collective on it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx

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


def _dp_rows(x: torch.Tensor, mesh, axes):
    """(every data rank's rows of ``x`` in rank order over "dp", this
    rank's block index); the gather's backward sums over "dp"."""
    index = 0
    for a in axes:
        index = index * coll.axis_size(mesh, a) + coll.coordinate(mesh, a)
    for a in reversed(axes):
        x = coll.all_gather(x, dim=0, axis=a, mesh=mesh,
                            replicated_grad=False)
    return x, index


def moe_mlp(p: MoE, x: torch.Tensor, cfg, stats: Optional[dict] = None,
            aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux loss).  Routing is per token, top_k experts.
    ``stats`` (a dict), when given, gets ``dropped``: the (device) count of
    assignments past capacity (over every data rank's rows).  ``aux``
    False: the caller never reads the aux loss, returned as 0."""
    E, G = cfg.n_experts, cfg.moe_groups
    mesh = dctx.get_mesh()
    axes = (dctx.physical_axes(mesh, "dp")
            if mesh is not None and dctx.rows_split() else ())
    dp = 1
    for a in axes:
        dp *= coll.axis_size(mesh, a)
    gather = dp > 1 and G % dp != 0
    if gather:
        rows, index = _dp_rows(x, mesh, axes)
        y, fracs, dropped = _routed(p, rows, cfg, G, stats is not None)
        y = y[index * x.shape[0]:(index + 1) * x.shape[0]]
    else:
        y, fracs, dropped = _routed(p, x, cfg, G // dp, stats is not None)
    local = dp > 1 and not gather
    if stats is not None:
        if local:
            for a in axes:
                dropped = coll.all_reduce_(dropped, a, mesh)
        stats["dropped"] = dropped

    # ---- shared experts + aux loss ------------------------------------------
    if p.shared is not None:
        y = y + L.swiglu_mlp(p.shared, x)
    if not aux:
        return y.to(x.dtype), torch.zeros((), device=x.device)
    frac_tokens, frac_probs = fracs
    if local:
        both = torch.stack([frac_tokens, frac_probs])
        for a in axes:
            both = coll.all_sum(both, a, mesh)
        frac_tokens, frac_probs = both / dp
    # load-balance loss (Switch): E * sum_e f_e * p_e
    return y.to(x.dtype), E * torch.sum(frac_tokens * frac_probs)


def _routed(p: MoE, x: torch.Tensor, cfg, G: int, drops: bool):
    """The routed experts of ``x`` (B, S, D) in ``G`` groups: (y in the
    experts' dtype, (frac_tokens, frac_probs) over these rows, with
    ``drops`` the count of assignments past capacity, else None)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
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

    # ---- expert FFN: placed stacks multiply their own out block ------------
    M.record_expert_inputs(p, "expert_in", dispatched)
    # w_gate and w_up have one shape (and one tile): they place alike
    placed = M.out_block(p.w_gate.kernel) is not None
    xin = coll.replicated(dispatched) if placed else dispatched
    h_g = torch.einsum("gecd,edf->gecf", xin,
                       expert_weight(p.w_gate, x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", xin,
                       expert_weight(p.w_up, x.dtype))
    h = M.gather_out(F.silu(h_g) * h_u, p.w_gate.kernel)
    M.record_expert_inputs(p, "expert_mid", h)
    if M.out_block(p.w_down.kernel) is not None:
        h = coll.replicated(h)
    out = M.gather_out(torch.einsum("gecf,efd->gecd", h,
                                    expert_weight(p.w_down, x.dtype)),
                       p.w_down.kernel)

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
    frac_tokens = torch.mean((gate_idx[..., None] == experts).float(),
                             dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return (y.reshape(B, S, D), (frac_tokens, frac_probs),
            (~keep).sum() if drops else None)
