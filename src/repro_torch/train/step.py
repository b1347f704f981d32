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
differentiable collectives (``dist.collectives``); the loss runs under
``dist.context.rows_over_dp``, so the MoE routes the global batch (see
``models.moe``).  Microbatches are cut from the global batch before a
data rank takes its block of each, so microbatch i holds the reference's
rows [i B/n, (i+1) B/n) on every mesh: the MoE's capacity couples a
microbatch's rows.  Every family trains on a mesh; an encdec batch's
``frames`` rows split over "dp" with its ``tokens``.
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
    device); with n_microbatches > 1 the global batch is split on axis
    0 (on a mesh, a data rank then takes its block of each microbatch),
    the gradients are summed in f32 and divided by the count, as is the
    loss.  Metrics: loss (the mean over the global batch on a mesh),
    grad_norm, lr (tensors on the device)."""

    def single(model, batch):
        loss, _, grads = loss_and_grads(model, cfg, batch)
        return loss, grads

    def accumulated(model, micro):
        acc, loss_sum = None, None
        for mb in micro:
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
        dev = model.embedding.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        n = n_microbatches
        micro = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(n)]
        rows = next(iter(micro[0].values())).shape[0]
        if mesh is not None and shd.MeshAxes(mesh).dp_size > 1:
            micro = [local_batch(mb, cfg, mesh) for mb in micro]
        # a data rank holds a block of each microbatch's rows (the batch
        # spec replicates rows that do not divide over "dp")
        split = next(iter(micro[0].values())).shape[0] < rows
        with dctx.rows_over_dp(split):
            if n > 1:
                loss, grads = accumulated(model, micro)
            else:
                loss, grads = single(model, micro[0])
        if split:
            grads = tree_lib.unflatten_tensors(
                grads, [dp_mean(g, mesh) for g in tree_lib.tensors(grads)])
            loss = dp_mean(loss.reshape(1), mesh)[0]
        _, opt_state, opt_metrics = apply_updates(
            convert.param_tree(model, cfg), grads, opt_state, optim_cfg)
        return model, opt_state, {"loss": loss, **opt_metrics}

    return train_step
