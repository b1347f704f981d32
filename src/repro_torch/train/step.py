"""train_step factory (port of ``repro.train.step``): loss -> grads ->
(clipped, scheduled) AdamW update, with optional microbatch gradient
accumulation in f32.

The model's weights are buffers (serving needs no gradients), so a step
switches ``requires_grad`` on for its fp tensors, takes
``torch.autograd.grad`` over them in the reference's leaf order, and
switches it off again: outside a step the model is the serving model.

On a mesh.  The step reads the active mesh (``dist.context.use_mesh``) at
call time, as the reference's GSPMD step runs under its mesh.  The model
was placed by ``dist.sharding.place_model`` (every product column-
parallel, its contraction dim whole) and the optimizer state made on its
blocks.  The batch's leading dim splits over "dp" (``spec_for_batch``);
each data rank's loss is the mean over its own rows, and every gradient
is summed over "dp" in f32 and divided by its size (a plain all-reduce,
as GSPMD's).  The gradients through the sharded layers come from the
differentiable collectives (``dist.collectives``).  The dense family
(GQA attention) trains on a multi-rank mesh; any other raises
``TypeError``, as the engine does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.models import api
from repro_torch.optim.adamw import OptimConfig, OptState, apply_updates


def loss_and_grads(model, cfg, batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads): grads in ``convert.param_tree``'s layout,
    each in its parameter's dtype."""
    params = convert.param_tree(model, cfg)
    flat = tree_lib.tensors(params)
    if not all(isinstance(t, torch.Tensor) and t.is_floating_point()
               for t in flat):
        raise TypeError("train_step needs an fp model (a quantized kernel "
                        "has no gradient)")
    for t in flat:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = api.loss_fn(model, cfg, batch)
            grads = torch.autograd.grad(loss, flat)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_lib.unflatten_tensors(params, grads))


def check_mesh_family(cfg, mesh) -> int:
    """The mesh's number of ranks; raises ``TypeError`` for a family the
    port does not shard yet on a multi-rank mesh (the engine's rule)."""
    shape = dctx.mesh_shape(mesh) if mesh is not None else {}
    ranks = 1
    for n in shape.values():
        ranks *= n
    if ranks > 1 and (cfg.family != "dense" or cfg.use_mla):
        raise TypeError(
            f"a mesh of {ranks} ranks trains the dense family with GQA "
            f"attention; {cfg.family}{' (MLA)' if cfg.use_mla else ''} "
            f"on a multi-rank mesh (expert placement, the latent cache, "
            f"recurrent state) is queued in ROADMAP.md, Queue 1 — train "
            f"it on one device")
    return ranks


def local_batch(batch: Dict[str, torch.Tensor], cfg, mesh):
    """This data rank's rows of a global batch (``spec_for_batch``)."""
    ax = shd.MeshAxes(mesh)
    coords = shd.mesh_coords(mesh)
    return {k: shd.local_shard(v, shd.spec_for_batch(k, tuple(v.shape), cfg,
                                                     ax), mesh, coords)
            for k, v in batch.items()}


def dp_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` in f32 summed over every "dp" axis of ``mesh`` and divided by
    the product of their sizes (the gradient average of data parallelism;
    a new tensor unless ``t`` is f32 already)."""
    ax = shd.MeshAxes(mesh)
    t = t.float()
    for a in ax.dp_axes:
        coll.all_reduce_(t, a, mesh)
    return t.div_(ax.dp_size)


def make_train_step(cfg, optim_cfg: OptimConfig, n_microbatches: int = 1):
    """Returns train_step(model, opt_state, batch) -> (model, opt,
    metrics), updating the model's tensors in place.

    batch leaves have leading dim global_batch (moved to the model's
    device); with n_microbatches > 1 the (rank's) batch is split on axis
    0, the gradients are summed in f32 and divided by the count, as is
    the loss.  Metrics: loss (the mean over the global batch on a mesh),
    grad_norm, lr (tensors on the device)."""

    def single(model, batch):
        loss, _, grads = loss_and_grads(model, cfg, batch)
        return loss, grads

    def accumulated(model, batch):
        acc, loss_sum = None, None
        for i in range(n_microbatches):
            mb = {k: v.reshape((n_microbatches, v.shape[0] // n_microbatches)
                               + v.shape[1:])[i] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(model, cfg, mb)
            if acc is None:
                acc = tree_lib.tree_map(lambda g: g.float(), grads)
                loss_sum = loss.float()
            else:
                for a, g in zip(tree_lib.tensors(acc),
                                tree_lib.tensors(grads)):
                    a.add_(g.float())
                loss_sum = loss_sum + loss
        for a in tree_lib.tensors(acc):
            a.div_(n_microbatches)
        return loss_sum / n_microbatches, acc

    def train_step(model, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        mesh = dctx.get_mesh()
        ranks = check_mesh_family(cfg, mesh)
        dev = model.embedding.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        if ranks > 1:
            batch = local_batch(batch, cfg, mesh)
        if n_microbatches > 1:
            loss, grads = accumulated(model, batch)
        else:
            loss, grads = single(model, batch)
        if ranks > 1 and shd.MeshAxes(mesh).dp_size > 1:
            grads = tree_lib.unflatten_tensors(
                grads, [dp_mean(g, mesh) for g in tree_lib.tensors(grads)])
            loss = dp_mean(loss.reshape(1), mesh)[0]
        _, opt_state, opt_metrics = apply_updates(
            convert.param_tree(model, cfg), grads, opt_state, optim_cfg)
        return model, opt_state, {"loss": loss, **opt_metrics}

    return train_step
