"""Seeded inputs of the model: the raw parts of every CLAQ matrix and the
dense leaves, drawn on the device from the run seed.

Each matrix and leaf has a stream of its own (``seeds.sub_seed(seed,
tag)``), so the reference draws any layer again, alone, and gets the same
values the program was given.  The draw of a CLAQ matrix is the one of
``chip_smoke.synthetic_qt`` (random codes, per-column sorted codebooks of
2^bits normal draws scaled by cols^-0.5, column bits about 90 % 2 / 5 % 3 /
5 % 4, and 0..3 reserved outliers a column), made for a whole stack of
experts in one call per part.  The program packs the parts itself
(``program.py``); the reference dequantizes them (``dequantize``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import seeds

BIT_MIX = (0.05, 0.05)       # shares of 3- and 4-bit columns
K_OUT = 3                    # most reserved outliers a column
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Parts:
    """A (*stack, rows, cols) CLAQ matrix in paper layout (out, in)."""
    codes: torch.Tensor          # int64 codes, original column order
    codebooks: torch.Tensor      # (*stack, cols, 16) f32, +inf past 2^bits
    column_bits: np.ndarray      # (*stack, cols)
    counts: np.ndarray           # (*stack, cols) reserved outliers
    Q: torch.Tensor              # f32 values taken where ``mask``
    mask: torch.Tensor           # bool reserved positions


def generators(seed: int, tag: str, device) -> Tuple[torch.Generator,
                                                     torch.Generator]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.sub_seed(seed, tag))
    host = torch.Generator()
    host.manual_seed(seeds.sub_seed(seed, tag + ":host"))
    return gen, host


def draw_parts(seed: int, tag: str, rows: int, cols: int, stack=(),
               device="cuda") -> Parts:
    """The raw parts of the matrix ``tag`` (a stack of ``stack`` matrices
    of one stripe layout: every member has as many 3- and 4-bit
    columns)."""
    gen, host = generators(seed, tag, device)
    stack = tuple(stack)
    n = int(np.prod(stack)) if stack else 1
    bits = np.full((n, cols), 2, np.int64)
    n3, n4 = (max(1, round(s * cols)) for s in BIT_MIX)
    for i in range(n):
        perm = torch.randperm(cols, generator=host).numpy()
        bits[i, perm[:n3]] = 3
        bits[i, perm[n3:n3 + n4]] = 4
    bits = bits.reshape(stack + (cols,))
    levels = torch.as_tensor(1 << bits, device=device)
    codes = torch.randint(0, 1 << 16, stack + (rows, cols), generator=gen,
                          device=device)
    codes %= levels.unsqueeze(-2)
    # a column's levels are its first 2^bits draws, sorted
    cb = torch.randn(stack + (cols, 16), generator=gen, device=device) \
        * cols ** -0.5
    cb = torch.sort(torch.where(torch.arange(16, device=device)
                                < levels.unsqueeze(-1), cb, float("inf")),
                    dim=-1).values
    counts = torch.randint(0, K_OUT + 1, stack + (cols,),
                           generator=host).numpy()
    Q = torch.randn(stack + (rows, cols), generator=gen, device=device) \
        * (4 * cols ** -0.5)
    r0 = torch.randint(0, rows, stack + (cols,), generator=gen,
                       device=device)
    cnt = torch.as_tensor(counts, device=device)
    mask = torch.zeros(stack + (rows, cols), dtype=torch.int8,
                       device=device)
    for j in range(K_OUT):              # K_OUT distinct rows a column
        at = ((r0 + j * (rows // K_OUT)) % rows).unsqueeze(-2)
        mask.scatter_(-2, at, (cnt > j).to(torch.int8).unsqueeze(-2))
    return Parts(codes, cb, bits, counts, Q, mask.bool())


def dequantize(p: Parts) -> torch.Tensor:
    """The matrix the parts stand for, in f32: each weight its column's
    codebook entry at its code, or its reserved value."""
    cb = torch.where(torch.isfinite(p.codebooks), p.codebooks, 0.0)
    W = torch.gather(cb, -1, p.codes.transpose(-1, -2)).transpose(-1, -2)
    return torch.where(p.mask, p.Q, W)


def normal(seed: int, tag: str, shape, scale: float, dtype,
           device="cuda") -> torch.Tensor:
    gen, _ = generators(seed, tag, device)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * scale).to(dtype)


def norm_scale(seed: int, tag: str, n: int, device="cuda") -> torch.Tensor:
    """An RMS norm's f32 scale, 1 + 0.1 N(0, 1) an entry."""
    return 1.0 + normal(seed, tag, (n,), 0.1, torch.float32, device)


def layer_matrices(m: dict, i: int) -> List[Tuple[str, int, int, tuple]]:
    """(tag, rows, cols, stack) of layer ``i``'s CLAQ matrices: attention
    q, k, v, o, then a SwiGLU's gate, up, down or the experts' stacks."""
    D, H, KH, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = [(f"L{i}.q", H * hd, D, ()), (f"L{i}.k", KH * hd, D, ()),
           (f"L{i}.v", KH * hd, D, ()), (f"L{i}.o", D, H * hd, ())]
    if m["family"] == "moe":
        E, Fe = m["n_experts"], m["d_ff_expert"]
        out += [(f"L{i}.w_gate", Fe, D, (E,)), (f"L{i}.w_up", Fe, D, (E,)),
                (f"L{i}.w_down", D, Fe, (E,))]
    else:
        F = m["d_ff"]
        out += [(f"L{i}.gate", F, D, ()), (f"L{i}.up", F, D, ()),
                (f"L{i}.down", D, F, ())]
    return out


def dense_leaves(m: dict, seed: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Every dense leaf: the embedding (and an untied head) in the model's
    dtype, f32 norm scales (qk-norm's too) and MoE routers."""
    D, V, hd = m["d_model"], m["vocab"], m["head_dim"]
    dt = DTYPES[m["dtype"]]
    out = {"embed": normal(seed, "embed", (V, D), 0.02, dt, device),
           "final_norm": norm_scale(seed, "final_norm", D, device)}
    if not m["tie_embeddings"]:
        out["lm_head"] = normal(seed, "lm_head", (D, V), D ** -0.5, dt,
                                device)
    for i in range(m["n_layers"]):
        out[f"L{i}.ln1"] = norm_scale(seed, f"L{i}.ln1", D, device)
        out[f"L{i}.ln2"] = norm_scale(seed, f"L{i}.ln2", D, device)
        if m["qk_norm"]:
            out[f"L{i}.q_norm"] = norm_scale(seed, f"L{i}.q_norm", hd, device)
            out[f"L{i}.k_norm"] = norm_scale(seed, f"L{i}.k_norm", hd, device)
        if m["family"] == "moe":
            out[f"L{i}.router"] = normal(seed, f"L{i}.router",
                                         (D, m["n_experts"]), D ** -0.5,
                                         torch.float32, device)
    return out
