"""Weights in from numpy and back out: the reference package's parameter
tree, given as numpy arrays, becomes the port's modules, and
``to_numpy_tree`` gives it back (``from_numpy_tree(to_numpy_tree(m))`` is
bitwise ``m``).

The tree has the reference's layout — ``embed.embedding``, layer-stacked
``blocks`` leaves with a leading ``(L, ...)`` axis, ``final_norm.scale``,
``lm_head.kernel`` — and is unstacked here into one module per layer
(MoE expert leaves ``mlp.w_gate`` etc. keep their ``(E, ...)`` axis).
rwkv blocks hold ``tm``/``cm`` subtrees and layer norms (``final_norm``
has a ``bias``); the hybrid's blocks are flat Mamba2 leaves beside
``shared_attn`` and the site-stacked ``site_lora``; encdec has
``enc_blocks``/``dec_blocks``, ``enc_norm`` and ``lm_head``.  A
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
from repro_torch.models import encdec as ed
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_lib
from repro_torch.models import modules as M
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as tf

# MLA's leaves in ``mla.MLA``'s argument order; the MoE expert stacks
_MLA_LEAVES = ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up",
               "o")
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# rwkv time-mix dense leaves (``rwkv6.TimeMix``'s order, "o" last) and
# channel-mix ones; Mamba2's tensor leaves in ``mamba2.Mamba``'s order
_TM_DENSE = ("r", "k", "v", "g", "w_lora_a", "w_lora_b", "o")
_CM_DENSE = ("k", "v", "r")
_MAMBA_ARRAYS = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")


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


def _attention(at, i, cfg, dev) -> L.Attention:
    """A GQA attention subtree (layer ``i`` of a stack, or unstacked with
    ``i`` None)."""
    def arr(a):
        a = np.asarray(a)
        return tensor_from_numpy(a if i is None else a[i], dev)
    return L.Attention(
        *(_dense(at[n], i, dev) for n in ("q", "k", "v", "o")),
        q_norm=arr(at["q_norm"]["scale"]) if cfg.qk_norm else None,
        k_norm=arr(at["k_norm"]["scale"]) if cfg.qk_norm else None)


def _gelu(ml, i, dev) -> L.GeluMLP:
    return L.GeluMLP(_dense(ml["up"], i, dev), _dense(ml["down"], i, dev))


def _swiglu(ml, i, dev) -> L.SwiGLU:
    return L.SwiGLU(*(_dense(ml[n], i, dev) for n in ("gate", "up", "down")))


def _encdec_from_numpy(tree, cfg, dev) -> ed.EncDec:
    def arr(a, i):
        return tensor_from_numpy(np.asarray(a)[i], dev)

    eb, db = tree["enc_blocks"], tree["dec_blocks"]
    enc = [ed.EncBlock(arr(eb["ln1"]["scale"], i),
                       _attention(eb["attn"], i, cfg, dev),
                       arr(eb["ln2"]["scale"], i), _gelu(eb["mlp"], i, dev))
           for i in range(cfg.enc_layers)]
    dec = [ed.DecBlock(arr(db["ln1"]["scale"], i),
                       _attention(db["attn"], i, cfg, dev),
                       arr(db["ln_x"]["scale"], i),
                       ed.CrossAttention(*(_dense(db["cross"][n], i, dev)
                                           for n in ("q", "k", "v", "o"))),
                       arr(db["ln2"]["scale"], i), _gelu(db["mlp"], i, dev))
           for i in range(cfg.dec_layers)]
    return ed.EncDec(tensor_from_numpy(tree["embed"]["embedding"], dev), enc,
                     dec, tensor_from_numpy(tree["enc_norm"]["scale"], dev),
                     tensor_from_numpy(tree["final_norm"]["scale"], dev),
                     _dense(tree["lm_head"], None, dev))


def from_numpy_tree(tree: Dict[str, Any], cfg, device="cuda"):
    """The reference's parameter tree -> ``Transformer`` (``EncDec`` for
    the encdec family)."""
    tf.validate_family(cfg)
    dev = dev_lib.resolve(device)
    if cfg.family == "encdec":
        return _encdec_from_numpy(tree, cfg, dev)
    blk = tree["blocks"]

    def arr(a, i):
        return tensor_from_numpy(np.asarray(a)[i], dev)

    def experts(leaf, i):       # a layer's (E, ...) stack, fp or quantized
        if isinstance(leaf, dict):
            return M.Dense(quantized_from_numpy(leaf, dev, i))
        return M.Dense(arr(leaf, i))

    def block(i):
        if cfg.family == "rwkv":
            t, c = blk["tm"], blk["cm"]
            tm = rwkv.TimeMix(
                arr(t["mix"], i),
                *(_dense(t[n], i, dev) for n in _TM_DENSE[:-1]),
                arr(t["w_bias"], i), arr(t["u_bonus"], i),
                arr(t["ln_x"]["scale"], i), arr(t["ln_x"]["bias"], i),
                _dense(t["o"], i, dev))
            cm = rwkv.ChannelMix(arr(c["mix"], i),
                                 *(_dense(c[n], i, dev) for n in _CM_DENSE))
            return tf.RWKVBlock(arr(blk["ln1"]["scale"], i),
                                arr(blk["ln1"]["bias"], i),
                                arr(blk["ln2"]["scale"], i),
                                arr(blk["ln2"]["bias"], i), tm, cm)
        if cfg.family == "hybrid":
            mamba = m2.Mamba(_dense(blk["in_proj"], i, dev),
                             *(arr(blk[n], i) for n in _MAMBA_ARRAYS),
                             arr(blk["norm"]["scale"], i),
                             _dense(blk["out_proj"], i, dev))
            return tf.HybridLayer(arr(blk["ln"]["scale"], i), mamba)
        at = blk["attn"]
        if cfg.use_mla:
            attn = mla_lib.MLA(
                *(arr(at[n]["scale"], i) if n.endswith("norm")
                  else _dense(at[n], i, dev) for n in _MLA_LEAVES))
        else:
            attn = _attention(at, i, cfg, dev)
        ml = blk["mlp"]
        if cfg.family == "moe":
            mlp = moe_lib.MoE(
                _dense(ml["router"], i, dev),
                *(experts(ml[n], i) for n in _EXPERT_LEAVES),
                shared=_swiglu(ml["shared"], i, dev) if "shared" in ml
                else None)
        elif cfg.mlp_type == "gelu":
            mlp = _gelu(ml, i, dev)
        else:
            mlp = _swiglu(ml, i, dev)
        return tf.Block(arr(blk["ln1"]["scale"], i),
                        arr(blk["ln2"]["scale"], i), attn, mlp)

    blocks = [block(i) for i in range(cfg.n_layers)]
    head = (None if cfg.tie_embeddings
            else _dense(tree["lm_head"], None, dev))
    fn = tree["final_norm"]
    shared = sites = None
    if "shared_attn" in tree:
        sa = tree["shared_attn"]
        a = _attention(sa, None, cfg, dev)
        shared = tf.SharedAttention(
            a.q, a.k, a.v, a.o, tensor_from_numpy(sa["ln"]["scale"], dev),
            tensor_from_numpy(sa["ln2"]["scale"], dev),
            _swiglu(sa["mlp"], None, dev), a.q_norm, a.k_norm)
        sl = tree["site_lora"]
        sites = [tf.SiteLora(arr(sl["lora_a"], s), arr(sl["lora_b"], s))
                 for s in range(np.asarray(sl["lora_a"]).shape[0])]
    return tf.Transformer(
        tensor_from_numpy(tree["embed"]["embedding"], dev), blocks,
        tensor_from_numpy(fn["scale"], dev), head,
        final_norm_bias=(tensor_from_numpy(fn["bias"], dev)
                         if "bias" in fn else None),
        shared_attn=shared, site_lora=sites)


def _dense_leaf(d: M.Dense) -> Dict[str, Any]:
    out = {"kernel": d.kernel}
    if d.bias is not None:
        out["bias"] = d.bias
    return out


def param_tree(model, cfg) -> Dict[str, Any]:
    """The model's tensors in the reference's layout (no copies):
    ``blocks`` (``enc_blocks``/``dec_blocks``, ``site_lora``) leaves are
    ``LayerStack``s of the per-layer tensors (a kernel may be a
    QuantizedTensor, an expert leaf a stacked one), then ``embed``,
    ``final_norm`` and, unless embeddings are tied, ``lm_head``."""
    tf.validate_family(cfg)

    def stacker(blocks):
        def stack(get):
            return tree_lib.LayerStack(get(b) for b in blocks)

        def dense(get):
            out = {"kernel": stack(lambda b: get(b).kernel)}
            if get(blocks[0]).bias is not None:
                out["bias"] = stack(lambda b: get(b).bias)
            return out

        def denses(get, names):
            return {n: dense(lambda b, n=n: getattr(get(b), n))
                    for n in names}
        return stack, dense, denses

    def attention(get, denses, stack):
        attn = denses(get, "qkvo")
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": stack(lambda b: get(b).q_norm)}
            attn["k_norm"] = {"scale": stack(lambda b: get(b).k_norm)}
        return attn

    if cfg.family == "encdec":
        es, _, edenses = stacker(list(model.enc_blocks))
        ds, _, ddenses = stacker(list(model.dec_blocks))
        return {
            "dec_blocks": {
                "attn": attention(lambda b: b.attn, ddenses, ds),
                "cross": ddenses(lambda b: b.cross, "qkvo"),
                "ln1": {"scale": ds(lambda b: b.ln1)},
                "ln2": {"scale": ds(lambda b: b.ln2)},
                "ln_x": {"scale": ds(lambda b: b.ln_x)},
                "mlp": ddenses(lambda b: b.mlp, ("up", "down"))},
            "embed": {"embedding": model.embedding},
            "enc_blocks": {
                "attn": attention(lambda b: b.attn, edenses, es),
                "ln1": {"scale": es(lambda b: b.ln1)},
                "ln2": {"scale": es(lambda b: b.ln2)},
                "mlp": edenses(lambda b: b.mlp, ("up", "down"))},
            "enc_norm": {"scale": model.enc_norm},
            "final_norm": {"scale": model.final_norm},
            "lm_head": _dense_leaf(model.lm_head)}

    blocks = list(model.blocks)
    stack, dense, denses = stacker(blocks)
    if cfg.family == "rwkv":
        tm = denses(lambda b: b.tm, _TM_DENSE)
        tm.update(mix=stack(lambda b: b.tm.mix),
                  w_bias=stack(lambda b: b.tm.w_bias),
                  u_bonus=stack(lambda b: b.tm.u_bonus),
                  ln_x={"scale": stack(lambda b: b.tm.ln_x_scale),
                        "bias": stack(lambda b: b.tm.ln_x_bias)})
        cm = denses(lambda b: b.cm, _CM_DENSE)
        cm["mix"] = stack(lambda b: b.cm.mix)
        bt = {"tm": tm, "cm": cm,
              "ln1": {"scale": stack(lambda b: b.ln1),
                      "bias": stack(lambda b: b.ln1_bias)},
              "ln2": {"scale": stack(lambda b: b.ln2),
                      "bias": stack(lambda b: b.ln2_bias)}}
    elif cfg.family == "hybrid":
        bt = denses(lambda b: b.mamba, ("in_proj", "out_proj"))
        bt.update({n: stack(lambda b, n=n: getattr(b.mamba, n))
                   for n in _MAMBA_ARRAYS})
        bt["norm"] = {"scale": stack(lambda b: b.mamba.norm)}
        bt["ln"] = {"scale": stack(lambda b: b.ln)}
    else:
        if cfg.use_mla:
            attn = denses(lambda b: b.attn, [n for n in _MLA_LEAVES
                                             if not n.endswith("norm")])
            for n in ("q_norm", "kv_norm"):
                attn[n] = {"scale": stack(lambda b, n=n: getattr(b.attn, n))}
        else:
            attn = attention(lambda b: b.attn, denses, stack)
        if cfg.family == "moe":
            mlp = denses(lambda b: b.mlp, ("router",))
            for n in _EXPERT_LEAVES:
                mlp[n] = stack(lambda b, n=n: getattr(b.mlp, n).kernel)
            if blocks[0].mlp.shared is not None:
                mlp["shared"] = denses(lambda b: b.mlp.shared,
                                       ("gate", "up", "down"))
        else:
            mlp = denses(lambda b: b.mlp, ("up", "down")
                         if cfg.mlp_type == "gelu"
                         else ("gate", "up", "down"))
        bt = {"attn": attn, "ln1": {"scale": stack(lambda b: b.ln1)},
              "ln2": {"scale": stack(lambda b: b.ln2)}, "mlp": mlp}
    out = {"blocks": bt, "embed": {"embedding": model.embedding},
           "final_norm": {"scale": model.final_norm}}
    if model.final_norm_bias is not None:
        out["final_norm"]["bias"] = model.final_norm_bias
    if not cfg.tie_embeddings:
        out["lm_head"] = _dense_leaf(model.lm_head)
    if model.shared_attn is not None:
        sp = model.shared_attn
        sa = {n: _dense_leaf(getattr(sp, n)) for n in "qkvo"}
        if cfg.qk_norm:
            sa["q_norm"] = {"scale": sp.q_norm}
            sa["k_norm"] = {"scale": sp.k_norm}
        sa.update(ln={"scale": sp.ln}, ln2={"scale": sp.ln2},
                  mlp={n: _dense_leaf(getattr(sp.mlp, n))
                       for n in ("gate", "up", "down")})
        sites = list(model.site_lora)
        out["shared_attn"] = sa
        out["site_lora"] = {
            "lora_a": tree_lib.LayerStack(s.lora_a for s in sites),
            "lora_b": tree_lib.LayerStack(s.lora_b for s in sites)}
    return out


def _leaf_to_numpy(leaf):
    """One tree leaf to numpy: a tensor, or a ``LayerStack`` stacked on a
    leading layer axis (of QuantizedTensors: their dict form)."""
    if isinstance(leaf, tree_lib.LayerStack):
        if not isinstance(leaf[0], torch.Tensor):
            return quantized_to_numpy(leaf)
        return np.stack([tensor_to_numpy(t) for t in leaf])
    return tensor_to_numpy(leaf)


def to_numpy_tree(model, cfg) -> Dict[str, Any]:
    """The model as the reference's numpy parameter tree, the inverse of
    ``from_numpy_tree``: layer-stacked ``blocks`` leaves, a quantized
    kernel in its dict form (an unstacked one too: the hybrid's shared
    block)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, QuantizedTensor):
            return quantized_to_numpy(node)
        return _leaf_to_numpy(node)
    return conv(param_tree(model, cfg))


def opt_state_to_numpy(opt) -> Dict[str, Any]:
    """An ``optim.OptState`` as numpy: ``m``/``v`` (and ``err``) in the
    params' layer-stacked layout, ``step`` an int32 scalar; the reference
    takes it as ``OptState(**d)``."""
    def conv(t):
        return None if t is None else tree_lib.map_with_name(
            lambda _, leaf: _leaf_to_numpy(leaf), t)
    return {"m": conv(opt.m), "v": conv(opt.v),
            "step": tensor_to_numpy(opt.step), "err": conv(opt.err)}


def opt_state_from_numpy(d: Dict[str, Any], model, cfg,
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

