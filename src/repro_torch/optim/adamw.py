"""AdamW + schedules + global-norm clipping (port of
``repro.optim.adamw``), plus the int8 gradient compression of its
error-feedback all-reduce.

Mixed precision as in the reference: params live in the model dtype (bf16
at scale), moments in f32; updates are computed in f32 and cast back.
Trees are ``repro_torch.tree`` containers (the params of a model:
``convert.param_tree``); leaves are visited in the reference's order, so
the global norm sums its leaves as the reference does.  ``apply_updates``
updates the params and the moments IN PLACE (a full-width model's
moments are GBs): the params tree holds the model's own tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    schedule: str = "cosine"       # cosine | linear | constant
    grad_compression: bool = False  # int8 error-feedback DP all-reduce


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor   # int32 scalar
    err: Any   # error-feedback residual (only when compression is on)


def init_opt_state(params, cfg: OptimConfig) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_lib.tensors(params)[0].device
    return OptState(m=tree_lib.tree_map(zeros, params),
                    v=tree_lib.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev),
                    err=(tree_lib.tree_map(zeros, params)
                         if cfg.grad_compression else None))


def schedule(step, cfg: OptimConfig) -> torch.Tensor:
    """The learning rate at ``step`` (f32 scalar): linear warmup, then
    cosine or linear decay to 0 at ``total_steps``, or constant."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in the reference's order (a ``LayerStack`` leaf as the sum of its
    layers' sums: within rounding of the reference's one reduction).

    On a mesh, ``shards`` says per leaf whether it is this rank's block of
    a tensor split over "model": those leaves' sum of squares is summed
    over "model" (one all-reduce), a replicated leaf counts once, so the
    norm is the same on every rank."""
    sq = sh = None
    for i, leaf in enumerate(tree_lib.leaves(tree)):
        parts = leaf if isinstance(leaf, tree_lib.LayerStack) else [leaf]
        s = None
        for t in parts:
            ts = torch.sum(torch.square(t.float()))
            s = ts if s is None else s + ts
        if shards is not None and shards[i]:
            sh = s if sh is None else sh + s
        else:
            sq = s if sq is None else sq + s
    if sh is not None:
        sh = coll.all_reduce_(sh.reshape(1), "model")[0]
        sq = sh if sq is None else sq + sh
    return torch.sqrt(sq)


def model_shards(params):
    """Per leaf of ``params``, whether it is a model shard
    (``dist.sharding.place_model``), or None off a multi-rank model
    axis."""
    if coll.axis_size(dctx.get_mesh(), "model") == 1:
        return None
    return [coll.model_shard(leaf[0] if isinstance(leaf, tree_lib.LayerStack)
                             else leaf) is not None
            for leaf in tree_lib.leaves(params)]


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """(grads * min(1, max_norm / norm) in f32, norm)."""
    gn = global_norm(grads, shards)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptimConfig):
    """One AdamW step: clip, schedule, update.  ``params`` and the moments
    are updated in place; returns (params, state, {"grad_norm", "lr"}).
    On a mesh the leaves are this rank's blocks (elementwise updates) and
    the clip reads the global norm over every rank's blocks."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm,
                                    model_shards(params))
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_lib.tensors(params), tree_lib.tensors(grads),
                          tree_lib.tensors(state.m),
                          tree_lib.tensors(state.v)):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    return params, OptState(state.m, state.v, step, state.err), {
        "grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression and its all-reduce
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: g ~ q * scale."""
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, err, group=None):
    """Error-feedback compressed data-parallel all-reduce over a
    ``torch.distributed`` process group (default: the world): each rank
    quantizes (grad + residual) to int8 under a GLOBAL scale (a MAX
    ``all_reduce`` of the local scales, so the payloads are additive),
    sums the int8 payload as int32 (a SUM ``all_reduce``), divides by the
    group size, and keeps what the compression dropped as the residual for
    the next step (Karimireddy et al. 2019).  ``grads`` and ``err`` are
    trees of one structure (``tree.tensors`` order); returns (mean
    gradients, new residuals) as trees of that structure."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    means, resid = [], []
    for g, e in zip(tree_lib.tensors(grads), tree_lib.tensors(err)):
        gf = g.float() + e
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qs = q.to(torch.int32)
        dist.all_reduce(qs, group=group)
        means.append(qs.float() * scale / n)
        resid.append(gf - q.float() * scale)
    return (tree_lib.unflatten_tensors(grads, means),
            tree_lib.unflatten_tensors(err, resid))
