"""Nested containers of tensors named and ordered as ``jax.tree_util``
names and orders the reference's pytrees.

A tree is made of dicts (keys visited in sorted order, named
``['key']``), NamedTuples and the CLAQ dataclasses (fields named
``.field``; ``QuantStripe.bits`` and ``QuantizedTensor.shape`` are static
and hold no leaf, as in the reference's registration), lists and tuples
(``[i]``), ``None`` (no leaf) and leaves: tensors, numpy arrays and
``LayerStack``s.  ``flatten`` gives the leaves in the reference's order
with ``jax.tree_util.keystr``'s names, e.g.
``['params']['blocks']['attn']['q']['kernel']`` or ``['opt'].m[...]``,
so the optimizer sums its norm in the reference's order and checkpoints
of both packages name their leaves alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core.quantized import QuantStripe, QuantizedTensor

_DATA_FIELDS = {QuantStripe: ("packed", "codebook"),
                QuantizedTensor: ("stripes", "col_perm", "out_idx", "out_val",
                                  "out_count")}


class LayerStack(list):
    """One reference leaf with a leading (L, ...) layer axis, held as its L
    per-layer tensors (the port keeps one module per layer).  A leaf of
    the tree: checkpoints stack it on save and split it on restore."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(name suffix, child) of a container node, in the reference's
    order."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if type(node) in _DATA_FIELDS:
        return [(f".{f}", getattr(node, f)) for f in _DATA_FIELDS[type(node)]]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _is_container(node) -> bool:
    return (not isinstance(node, LayerStack)
            and (isinstance(node, (dict, list, tuple))
                 or type(node) in _DATA_FIELDS))


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr name, leaf)] in the reference's flatten order."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out.extend(flatten(child, prefix + name))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def map_with_name(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """A tree of the same structure with each leaf replaced by
    ``fn(name, leaf)``, called in flatten order."""
    if tree is None:
        return None
    if not _is_container(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_name(fn, tree[k], f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if type(tree) in _DATA_FIELDS:
        return dataclasses.replace(tree, **{
            f: map_with_name(fn, getattr(tree, f), f"{prefix}.{f}")
            for f in _DATA_FIELDS[type(tree)]})
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_name(fn, getattr(tree, f),
                                          f"{prefix}.{f}")
                            for f in tree._fields))
    return type(tree)(map_with_name(fn, c, f"{prefix}[{i}]")
                      for i, c in enumerate(tree))


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` on every leaf; a ``LayerStack`` leaf is mapped layer by layer
    (into a new ``LayerStack``)."""
    def one(_, leaf):
        if isinstance(leaf, LayerStack):
            return LayerStack(fn(t) for t in leaf)
        return fn(leaf)
    return map_with_name(one, tree)


def tensors(tree) -> List[Any]:
    """Every tensor of the tree, ``LayerStack``s expanded layer by layer,
    in flatten order: the unit the optimizer updates."""
    out = []
    for leaf in leaves(tree):
        out.extend(leaf if isinstance(leaf, LayerStack) else [leaf])
    return out


def unflatten_tensors(template, flat):
    """A tree shaped as ``template`` whose tensors (``LayerStack``s
    expanded, as ``tensors`` lists them) are taken from ``flat`` in
    order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), template)
    assert next(it, None) is None, "more tensors than the template holds"
    return out


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s (same structure) in place:
    how a restored state reaches a model's own tensors."""
    a, b = tensors(dst), tensors(src)
    assert len(a) == len(b)
    for d, s in zip(a, b):
        d.copy_(s)
