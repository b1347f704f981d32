"""The system under test: ``repro_torch``'s model built from the benchmark's
seeded parts, served by its ``ServingEngine``.

The port receives the raw parts through its own ``build_quantized_tensor``
(experts stacked by ``stack_quantized``), and the engine prepares them into
K1 plans (``prepare=True``).  Nothing here computes a result: that is the
port's, judged by ``reference.py``.
"""
from __future__ import annotations

import dataclasses

from . import weights as W


def port_config(model: dict):
    """The port's ``ModelConfig`` of the architecture ``model["arch"]``
    with every key of ``model`` it has set to the file's value."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import get_config
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return dataclasses.replace(get_config(model["arch"]),
                               **{k: v for k, v in model.items()
                                  if k in fields})


def _claq(parts: W.Parts):
    from repro_torch.core.quantized import (build_quantized_tensor,
                                            stack_quantized)
    if parts.codes.dim() == 2:
        return build_quantized_tensor(parts.codes, parts.codebooks,
                                      parts.column_bits, parts.counts,
                                      parts.Q, parts.mask)
    return stack_quantized([
        build_quantized_tensor(parts.codes[e], parts.codebooks[e],
                               parts.column_bits[e], parts.counts[e],
                               parts.Q[e], parts.mask[e])
        for e in range(parts.codes.shape[0])])


def build_model(m: dict, seed: int, device):
    """The port's Transformer of the configuration ``m`` with the weights
    of ``seed``: every block matmul a CLAQ tensor, the rest dense."""
    from repro_torch.models import layers as L
    from repro_torch.models import modules as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    dense = W.dense_leaves(m, seed, device)
    blocks = []
    for i in range(m["n_layers"]):
        q = {tag.split(".")[1]: M.Dense(_claq(W.draw_parts(
            seed, tag, rows, cols, stack, device)))
            for tag, rows, cols, stack in W.layer_matrices(m, i)}
        attn = L.Attention(q["q"], q["k"], q["v"], q["o"],
                           dense.get(f"L{i}.q_norm"),
                           dense.get(f"L{i}.k_norm"))
        if m["family"] == "moe":
            mlp = moe_lib.MoE(M.Dense(dense[f"L{i}.router"]), q["w_gate"],
                              q["w_up"], q["w_down"], None)
        else:
            mlp = L.SwiGLU(q["gate"], q["up"], q["down"])
        blocks.append(tf.Block(dense[f"L{i}.ln1"], dense[f"L{i}.ln2"], attn,
                               mlp))
    head = dense.get("lm_head")
    return tf.Transformer(dense["embed"], blocks, dense["final_norm"],
                          None if head is None else M.Dense(head))


def engine(model, cfg, traffic, device):
    """The port's engine over ``model``: greedy decode, a KV cache in the
    model's dtype (bf16 for the cells), ``traffic.slots`` slots of
    ``traffic.max_len`` positions."""
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(model, cfg, n_slots=traffic.slots,
                         max_len=traffic.max_len,
                         dtype=W.DTYPES[cfg.dtype], prepare=True,
                         device=device)
