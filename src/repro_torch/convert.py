"""Weights in from numpy: the reference package's parameter tree, given as
numpy arrays, becomes the port's modules.

The tree has the reference's layout — ``embed.embedding``, layer-stacked
``blocks`` leaves with a leading ``(L, ...)`` axis, ``final_norm.scale``,
``lm_head.kernel`` — and is unstacked here into one module per layer.  A
CLAQ ``QuantizedTensor`` crosses as a plain dict::

    {"stripes": [{"packed": u32, "codebook": f32, "bits": int}, ...],
     "col_perm": i32, "out_idx": i32, "out_val": f32, "out_count": i32,
     "shape": (rows, cols)}

with the same optional leading layer axis on every array.  Packed words
keep their bits as int32 (see core/packing.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.core.quantized import QuantStripe, QuantizedTensor
from repro_torch.models import layers as L
from repro_torch.models import modules as M
from repro_torch.models import transformer as tf


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch on ``device``; uint32 becomes int32 with the same
    bits, bfloat16 (ml_dtypes) crosses through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def quantized_from_numpy(d: Dict[str, Any], device="cuda",
                         layer: Optional[int] = None) -> QuantizedTensor:
    """One QuantizedTensor from its dict form; ``layer`` picks one member
    of a layer-stacked dict."""
    dev = dev_lib.resolve(device)

    def t(a):
        a = np.asarray(a)
        return tensor_from_numpy(a if layer is None else a[layer], dev)

    stripes = tuple(QuantStripe(packed=t(s["packed"]),
                                codebook=t(s["codebook"]).float(),
                                bits=int(s["bits"])) for s in d["stripes"])
    return QuantizedTensor(
        stripes=stripes, col_perm=t(d["col_perm"]).to(torch.int32),
        out_idx=t(d["out_idx"]).to(torch.int32),
        out_val=t(d["out_val"]).float(),
        out_count=t(d["out_count"]).to(torch.int32),
        shape=tuple(int(v) for v in d["shape"]))


def _dense(leaf: Dict[str, Any], layer: Optional[int], dev) -> M.Dense:
    k = leaf["kernel"]
    if isinstance(k, dict):
        kernel = quantized_from_numpy(k, dev, layer)
    else:
        k = np.asarray(k)
        kernel = tensor_from_numpy(k if layer is None else k[layer], dev)
    b = leaf.get("bias")
    if b is not None:
        b = np.asarray(b)
        b = tensor_from_numpy(b if layer is None else b[layer], dev)
    return M.Dense(kernel, b)


def from_numpy_tree(tree: Dict[str, Any], cfg,
                    device="cuda") -> tf.Transformer:
    """The reference's dense-family parameter tree -> ``Transformer``."""
    tf.validate_family(cfg)
    dev = dev_lib.resolve(device)
    blk = tree["blocks"]

    def arr(a, i):
        return tensor_from_numpy(np.asarray(a)[i], dev)

    blocks = []
    for i in range(cfg.n_layers):
        at = blk["attn"]
        attn = L.Attention(
            *(_dense(at[n], i, dev) for n in ("q", "k", "v", "o")),
            q_norm=arr(at["q_norm"]["scale"], i) if cfg.qk_norm else None,
            k_norm=arr(at["k_norm"]["scale"], i) if cfg.qk_norm else None)
        ml = blk["mlp"]
        if cfg.mlp_type == "gelu":
            mlp = L.GeluMLP(_dense(ml["up"], i, dev),
                            _dense(ml["down"], i, dev))
        else:
            mlp = L.SwiGLU(*(_dense(ml[n], i, dev)
                             for n in ("gate", "up", "down")))
        blocks.append(tf.Block(arr(blk["ln1"]["scale"], i),
                               arr(blk["ln2"]["scale"], i), attn, mlp))
    head = (None if cfg.tie_embeddings
            else _dense(tree["lm_head"], None, dev))
    return tf.Transformer(tensor_from_numpy(tree["embed"]["embedding"], dev),
                          blocks,
                          tensor_from_numpy(tree["final_norm"]["scale"], dev),
                          head)
