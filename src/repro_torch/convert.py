"""Weights in from numpy and back out: the reference package's parameter
tree, given as numpy arrays, becomes the port's modules, and
``to_numpy_tree`` gives it back (``from_numpy_tree(to_numpy_tree(m))`` is
bitwise ``m``).

The tree has the reference's layout — ``embed.embedding``, layer-stacked
``blocks`` leaves with a leading ``(L, ...)`` axis, ``final_norm.scale``,
``lm_head.kernel`` — and is unstacked here into one module per layer
(MoE expert leaves ``mlp.w_gate`` etc. keep their ``(E, ...)`` axis).  A
CLAQ ``QuantizedTensor`` crosses as a plain dict::

    {"stripes": [{"packed": u32, "codebook": f32, "bits": int}, ...],
     "col_perm": i32, "out_idx": i32, "out_val": f32, "out_count": i32,
     "shape": (rows, cols)}

with the same optional leading layer (and expert) axes on every array.
Packed words keep their bits as int32 (see core/packing.py) and leave as
uint32.
``param_tree`` is the same layout over the model's own tensors, block
leaves as ``tree.LayerStack``s: the tree the optimizer and the
checkpoint walk.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch import tree as tree_lib
from repro_torch.core.quantized import QuantStripe, QuantizedTensor
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_lib
from repro_torch.models import modules as M
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf

# MLA's leaves in ``mla.MLA``'s argument order; the MoE expert stacks
_MLA_LEAVES = ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up",
               "o")
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host; bfloat16 leaves as numpy's bfloat16,
    which exists only where ``ml_dtypes`` has registered it (a process
    that imports the reference); checkpoints store bf16 without it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise TypeError("numpy has no bfloat16 type in this process "
                            "(ml_dtypes is not loaded); a checkpoint "
                            "stores bf16 without it") from None
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def quantized_to_numpy(qt) -> Dict[str, Any]:
    """A QuantizedTensor, or a ``LayerStack`` of per-layer ones with equal
    stripe shapes, in the dict form (stacked on a leading layer axis)."""
    members = list(qt) if isinstance(qt, tree_lib.LayerStack) else [qt]

    def arr(get, u32=False):
        a = [tensor_to_numpy(get(m)) for m in members]
        a = [x.view(np.uint32) for x in a] if u32 else a
        return a[0] if len(members) == 1 and not isinstance(
            qt, tree_lib.LayerStack) else np.stack(a)

    first = members[0]
    assert all(tuple(s.bits for s in m.stripes)
               == tuple(s.bits for s in first.stripes)
               and m.shape == first.shape for m in members)
    return {"stripes": [{"packed": arr(lambda m: m.stripes[i].packed, True),
                         "codebook": arr(lambda m: m.stripes[i].codebook),
                         "bits": s.bits}
                        for i, s in enumerate(first.stripes)],
            **{f: arr(lambda m, f=f: getattr(m, f))
               for f in ("col_perm", "out_idx", "out_val", "out_count")},
            "shape": tuple(first.shape)}


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
    """The reference's parameter tree (dense or moe family, GQA or MLA
    attention) -> ``Transformer``."""
    tf.validate_family(cfg)
    dev = dev_lib.resolve(device)
    blk = tree["blocks"]

    def arr(a, i):
        return tensor_from_numpy(np.asarray(a)[i], dev)

    def swiglu(ml, i):
        return L.SwiGLU(*(_dense(ml[n], i, dev)
                          for n in ("gate", "up", "down")))

    def experts(leaf, i):       # a layer's (E, ...) stack, fp or quantized
        if isinstance(leaf, dict):
            return M.Dense(quantized_from_numpy(leaf, dev, i))
        return M.Dense(arr(leaf, i))

    blocks = []
    for i in range(cfg.n_layers):
        at = blk["attn"]
        if cfg.use_mla:
            attn = mla_lib.MLA(
                *(arr(at[n]["scale"], i) if n.endswith("norm")
                  else _dense(at[n], i, dev) for n in _MLA_LEAVES))
        else:
            attn = L.Attention(
                *(_dense(at[n], i, dev) for n in ("q", "k", "v", "o")),
                q_norm=arr(at["q_norm"]["scale"], i) if cfg.qk_norm else None,
                k_norm=arr(at["k_norm"]["scale"], i) if cfg.qk_norm else None)
        ml = blk["mlp"]
        if cfg.family == "moe":
            mlp = moe_lib.MoE(
                _dense(ml["router"], i, dev),
                *(experts(ml[n], i) for n in _EXPERT_LEAVES),
                shared=swiglu(ml["shared"], i) if "shared" in ml else None)
        elif cfg.mlp_type == "gelu":
            mlp = L.GeluMLP(_dense(ml["up"], i, dev),
                            _dense(ml["down"], i, dev))
        else:
            mlp = swiglu(ml, i)
        blocks.append(tf.Block(arr(blk["ln1"]["scale"], i),
                               arr(blk["ln2"]["scale"], i), attn, mlp))
    head = (None if cfg.tie_embeddings
            else _dense(tree["lm_head"], None, dev))
    return tf.Transformer(tensor_from_numpy(tree["embed"]["embedding"], dev),
                          blocks,
                          tensor_from_numpy(tree["final_norm"]["scale"], dev),
                          head)


def param_tree(model: tf.Transformer, cfg) -> Dict[str, Any]:
    """The model's tensors in the reference's layout (no copies):
    ``blocks`` leaves are ``LayerStack``s of the per-layer tensors (a
    kernel may be a QuantizedTensor, an expert leaf a stacked one), then
    ``embed``, ``final_norm`` and, unless embeddings are tied,
    ``lm_head``."""
    tf.validate_family(cfg)
    blocks = list(model.blocks)

    def stack(get):
        return tree_lib.LayerStack(get(b) for b in blocks)

    def dense(get):
        out = {"kernel": stack(lambda b: get(b).kernel)}
        if get(blocks[0]).bias is not None:
            out["bias"] = stack(lambda b: get(b).bias)
        return out

    def denses(get, names):
        return {n: dense(lambda b, n=n: getattr(get(b), n)) for n in names}

    if cfg.use_mla:
        attn = denses(lambda b: b.attn, [n for n in _MLA_LEAVES
                                         if not n.endswith("norm")])
        for n in ("q_norm", "kv_norm"):
            attn[n] = {"scale": stack(lambda b, n=n: getattr(b.attn, n))}
    else:
        attn = denses(lambda b: b.attn, "qkvo")
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": stack(lambda b: b.attn.q_norm)}
            attn["k_norm"] = {"scale": stack(lambda b: b.attn.k_norm)}
    if cfg.family == "moe":
        mlp = denses(lambda b: b.mlp, ("router",))
        for n in _EXPERT_LEAVES:
            mlp[n] = stack(lambda b, n=n: getattr(b.mlp, n).kernel)
        if blocks[0].mlp.shared is not None:
            mlp["shared"] = denses(lambda b: b.mlp.shared,
                                   ("gate", "up", "down"))
    else:
        mlp = denses(lambda b: b.mlp, ("up", "down") if cfg.mlp_type == "gelu"
                     else ("gate", "up", "down"))
    out = {"blocks": {"attn": attn, "ln1": {"scale": stack(lambda b: b.ln1)},
                      "ln2": {"scale": stack(lambda b: b.ln2)}, "mlp": mlp},
           "embed": {"embedding": model.embedding},
           "final_norm": {"scale": model.final_norm}}
    if not cfg.tie_embeddings:
        head = model.lm_head
        out["lm_head"] = {"kernel": head.kernel}
        if head.bias is not None:
            out["lm_head"]["bias"] = head.bias
    return out


def _leaf_to_numpy(leaf):
    """One tree leaf to numpy: a tensor, or a ``LayerStack`` stacked on a
    leading layer axis (of QuantizedTensors: their dict form)."""
    if isinstance(leaf, tree_lib.LayerStack):
        if not isinstance(leaf[0], torch.Tensor):
            return quantized_to_numpy(leaf)
        return np.stack([tensor_to_numpy(t) for t in leaf])
    return tensor_to_numpy(leaf)


def to_numpy_tree(model: tf.Transformer, cfg) -> Dict[str, Any]:
    """The model as the reference's numpy parameter tree, the inverse of
    ``from_numpy_tree``: layer-stacked ``blocks`` leaves, a quantized
    kernel in its dict form."""
    return tree_lib.map_with_name(lambda _, leaf: _leaf_to_numpy(leaf),
                                  param_tree(model, cfg))


def opt_state_to_numpy(opt) -> Dict[str, Any]:
    """An ``optim.OptState`` as numpy: ``m``/``v`` (and ``err``) in the
    params' layer-stacked layout, ``step`` an int32 scalar; the reference
    takes it as ``OptState(**d)``."""
    def conv(t):
        return None if t is None else tree_lib.map_with_name(
            lambda _, leaf: _leaf_to_numpy(leaf), t)
    return {"m": conv(opt.m), "v": conv(opt.v),
            "step": tensor_to_numpy(opt.step), "err": conv(opt.err)}


def opt_state_from_numpy(d: Dict[str, Any], model: tf.Transformer, cfg,
                         device="cuda"):
    """The inverse of ``opt_state_to_numpy``: moments split into per-layer
    tensors in ``param_tree``'s layout."""
    from repro_torch.optim.adamw import OptState
    dev = dev_lib.resolve(device)
    tmpl = param_tree(model, cfg)

    def conv(np_tree):
        if np_tree is None:
            return None
        arrays = dict(tree_lib.flatten(np_tree))    # name -> array

        def one(name, leaf):
            a = arrays[name]
            if isinstance(leaf, tree_lib.LayerStack):
                return tree_lib.LayerStack(tensor_from_numpy(x, dev)
                                           for x in np.asarray(a))
            return tensor_from_numpy(a, dev)
        return tree_lib.map_with_name(one, tmpl)

    return OptState(m=conv(d["m"]), v=conv(d["v"]),
                    step=tensor_from_numpy(np.asarray(d["step"]), dev),
                    err=conv(d.get("err")))

