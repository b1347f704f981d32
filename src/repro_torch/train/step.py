"""train_step factory (port of ``repro.train.step``): loss -> grads ->
(clipped, scheduled) AdamW update, with optional microbatch gradient
accumulation in f32.

The model's weights are buffers (serving needs no gradients), so a step
switches ``requires_grad`` on for its fp tensors, takes
``torch.autograd.grad`` over them in the reference's leaf order, and
switches it off again: outside a step the model is the serving model.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
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


def make_train_step(cfg, optim_cfg: OptimConfig, n_microbatches: int = 1):
    """Returns train_step(model, opt_state, batch) -> (model, opt,
    metrics), updating the model's tensors in place.

    batch leaves have leading dim global_batch (moved to the model's
    device); with n_microbatches > 1 the batch is split on axis 0, the
    gradients are summed in f32 and divided by the count, as is the
    loss.  Metrics: loss, grad_norm, lr (tensors on the device)."""

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
        dev = model.embedding.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        if n_microbatches > 1:
            loss, grads = accumulated(model, batch)
        else:
            loss, grads = single(model, batch)
        _, opt_state, opt_metrics = apply_updates(
            convert.param_tree(model, cfg), grads, opt_state, optim_cfg)
        return model, opt_state, {"loss": loss, **opt_metrics}

    return train_step
