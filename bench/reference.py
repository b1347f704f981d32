"""The plain reference: the served model written out in float32 PyTorch from
the benchmark's own seeded parts, with no kernel, cache layout or batching
of the program (it imports nothing of ``repro_torch``).

The model is the port's Llama-style decoder: RMS norms (f32, eps from the
configuration), GQA attention with optional per-head RMS qk-norm before
RoPE, RoPE rotating the pairs (2i, 2i+1) by position x theta^(-2i/d),
causal softmax attention scaled by head_dim^-0.5, then a SwiGLU MLP or
the MoE layer, a final RMS norm and the (tied or own) head.  The MoE
layer routes each group of tokens (a prompt, or one decode step's rows in
slot order) by a softmax over the f32 router, a stable top-k (ties to the
lower expert), gates renormalized over the k, and drops every assignment
whose place among its expert's assignments, in token-then-k order, is
past ``capacity(T)`` = max(int(ceil(T k / E) * capacity_factor), 1); a
dropped assignment adds nothing.

``precision="fp8"`` is the control: every matmul's operands rounded to
float8 e4m3 (per token and per output row scales), the step below the
bf16 the configuration states.

Two ways to judge served tokens:

  * ``judge_sequences`` (rows independent, the dense family): each
    sampled request's prompt and served tokens in one causal forward,
    layer by layer over all of them;
  * ``replay`` (rows coupled through expert capacity, the moe family):
    the engine's schedule step by step (which request each step admitted
    into which slot, every slot's row in each decode step), with f32
    caches of its own, teacher-forced with the served tokens.

The number compared is the mean, over every judged token, of the gap by
which a served token's reference logit lies below the reference's best
logit at its position (the widest gap is reported beside it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import weights as W

NEG_INF = float("-inf")


def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fq8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per last-axis row."""
    s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., in) @ w^T for w (out, in) [or a batch of them]."""
    if prec == "fp8":
        x = fq8(x)          # w is rounded once, in ``Layer``
    return x @ w.transpose(-1, -2)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, d) rotated at positions ``pos`` (..., S)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[..., None] * inv
    c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


class Layer:
    """One block's weights in f32 (fp8-rounded rows for the control)."""

    def __init__(self, m: dict, seed: int, i: int, dense: dict, device,
                 prec: str):
        self.m = m
        self.prec = prec
        self.w = {}
        for tag, rows, cols, stack in W.layer_matrices(m, i):
            w = W.dequantize(W.draw_parts(seed, tag, rows, cols, stack,
                                          device))
            self.w[tag.split(".")[1]] = fq8(w) if prec == "fp8" else w
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            if f"L{i}.{name}" in dense:
                self.w[name] = dense[f"L{i}.{name}"].float()
        if m["family"] == "moe":
            r = dense[f"L{i}.router"].float().T.contiguous()   # (E, D)
            self.w["router"] = fq8(r) if prec == "fp8" else r

    def qkv(self, x: torch.Tensor, pos: torch.Tensor):
        """x (..., S, D) normed -> q (..., S, H, hd), k, v (..., S, KH, hd)
        with qk-norm and RoPE applied."""
        m, w, p = self.m, self.w, self.prec
        H, KH, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        q = linear(x, w["q"], p).unflatten(-1, (H, hd))
        k = linear(x, w["k"], p).unflatten(-1, (KH, hd))
        v = linear(x, w["v"], p).unflatten(-1, (KH, hd))
        if m["qk_norm"]:
            q = rms(q, w["q_norm"], m["norm_eps"])
            k = rms(k, w["k_norm"], m["norm_eps"])
        return (rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"]),
                v)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, D) normed, one routing group for the MoE."""
        w, p = self.w, self.prec
        if self.m["family"] != "moe":
            return linear(F.silu(linear(x, w["gate"], p))
                          * linear(x, w["up"], p), w["down"], p)
        return moe(x, w, self.m, p)


def capacity(T: int, m: dict) -> int:
    k, E = m["top_k"], m["n_experts"]
    return max(int(math.ceil(T * k / E) * m["capacity_factor"]), 1)


def moe(x: torch.Tensor, w: dict, m: dict, prec: str) -> torch.Tensor:
    """The routed experts of the T tokens ``x`` (T, D), one group."""
    T, D = x.shape
    E, K = m["n_experts"], m["top_k"]
    cap = capacity(T, m)
    probs = torch.softmax(linear(x, w["router"], prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :K] / vals[:, :K].sum(-1, keepdim=True).clamp_min(1e-9)
    expert = idx[:, :K].reshape(-1)                    # token-major, then k
    onehot = F.one_hot(expert, E)
    place = (torch.cumsum(onehot, 0) - 1).gather(1, expert[:, None])[:, 0]
    keep = place < cap
    where = torch.full((E * cap,), T, dtype=torch.long, device=x.device)
    token = torch.arange(T, device=x.device).repeat_interleave(K)
    where[(expert * cap + place)[keep]] = token[keep]
    xin = torch.cat([x, x.new_zeros(1, D)])[where].view(E, cap, D)
    h = F.silu(linear(xin, w["w_gate"], prec)) * linear(xin, w["w_up"], prec)
    out = linear(h, w["w_down"], prec).reshape(E * cap, D)
    src = out[(expert * cap + place).clamp(max=E * cap - 1)]
    src = src * torch.where(keep, gates.reshape(-1), 0.0)[:, None]
    return src.view(T, K, D).sum(1)


def attend(q, k, v, q_pos, kv_len) -> torch.Tensor:
    """q (B, Sq, H, d) at positions ``q_pos`` (B, Sq) over k/v (B, Skv, KH,
    d), each query seeing keys at positions <= its own and < kv_len
    (B,)."""
    H, KH = q.shape[2], k.shape[2]
    k = k.repeat_interleave(H // KH, dim=2)
    v = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    kp = torch.arange(k.shape[1], device=q.device)
    ok = ((kp[None, None, :] <= q_pos[:, :, None])
          & (kp[None, None, :] < kv_len[:, None, None]))
    s = torch.where(ok[:, None], s, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def head(m: dict, dense: dict, prec: str) -> torch.Tensor:
    """(V, D) f32 head rows (the embedding when tied)."""
    h = (dense["embed"] if m["tie_embeddings"] else dense["lm_head"].T)
    h = h.float().contiguous()
    return fq8(h) if prec == "fp8" else h


def _gaps(ref: torch.Tensor, served: torch.Tensor,
          ctrl: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                 Optional[torch.Tensor]]:
    """Per position: best reference logit minus the served token's, and
    minus that of the control's first choice."""
    best = ref.max(dim=-1).values
    gap = best - ref.gather(-1, served[:, None])[:, 0]
    if ctrl is None:
        return gap, None
    return gap, best - ref.gather(-1, ctrl.argmax(-1)[:, None])[:, 0]


class Judged:
    """The gaps of every judged token, under the reference and under the
    control's first choices."""

    def __init__(self):
        self.gaps: List[torch.Tensor] = []
        self.control: List[torch.Tensor] = []

    def add(self, gap: torch.Tensor, control: Optional[torch.Tensor]):
        self.gaps.append(gap.float().cpu())
        if control is not None:
            self.control.append(control.float().cpu())

    @property
    def tokens(self) -> int:
        return sum(g.numel() for g in self.gaps)

    def as_control(self) -> "Judged":
        """The control's gaps in the program's place, to be judged by the
        same comparison."""
        out = Judged()
        out.gaps = list(self.control)
        return out

    def stat(self, name: str, control: bool = False) -> float:
        """``widest`` or ``mean`` gap (0 over no token)."""
        parts = self.control if control else self.gaps
        if not parts or not sum(g.numel() for g in parts):
            return 0.0
        g = torch.cat(parts)
        return float(g.max() if name == "widest" else g.mean())


def judge_sequences(m: dict, seed: int, seqs: Sequence[Tuple[List[int],
                                                             List[int]]],
                    device, control: bool = False,
                    q_block: int = 512) -> Judged:
    """Each (prompt, served) in one causal forward of prompt + served[:-1],
    judged at the positions that chose the served tokens."""
    _setup()
    dense = W.dense_leaves(m, seed, device)
    precs = ["f32"] + (["fp8"] if control else [])
    emb = dense["embed"].float()
    toks = [torch.as_tensor(p + s[:-1], device=device) for p, s in seqs]
    hs = {p: [emb[t] for t in toks] for p in precs}
    for i in range(m["n_layers"]):
        for p in precs:
            layer = Layer(m, seed, i, dense, device, p)
            hs[p] = [_block_full(layer, h, q_block) for h in hs[p]]
            del layer
    out = Judged()
    heads = {p: head(m, dense, p) for p in precs}
    for j, (prompt, served) in enumerate(seqs):
        at = slice(len(prompt) - 1, len(prompt) - 1 + len(served))
        logits = {}
        for p in precs:
            x = rms(hs[p][j][at], dense["final_norm"].float(), m["norm_eps"])
            logits[p] = linear(x, heads[p], p)
        out.add(*_gaps(logits["f32"], torch.as_tensor(served, device=device),
                       logits.get("fp8")))
    return out


def _block_full(layer: Layer, h: torch.Tensor, q_block: int) -> torch.Tensor:
    """One block over a whole sequence h (S, D), causal, no cache."""
    m, w = layer.m, layer.w
    S = h.shape[0]
    pos = torch.arange(S, device=h.device)
    q, k, v = layer.qkv(rms(h, w["ln1"], m["norm_eps"]), pos)
    parts = []
    for s0 in range(0, S, q_block):
        qb = q[s0:s0 + q_block][None]
        parts.append(attend(qb, k[None], v[None], pos[None, s0:s0 + q_block],
                            torch.tensor([S], device=h.device))[0])
    a = torch.cat(parts).flatten(-2)
    h = h + linear(a, w["o"], layer.prec)
    return h + layer.mlp(rms(h, w["ln2"], m["norm_eps"]))


class Slots:
    """The reference's own f32 caches of every slot, one precision."""

    def __init__(self, m: dict, n_slots: int, max_len: int, device):
        shape = (n_slots, max_len, m["n_kv_heads"], m["head_dim"])
        self.k = [torch.zeros(shape, device=device)
                  for _ in range(m["n_layers"])]
        self.v = [torch.zeros(shape, device=device)
                  for _ in range(m["n_layers"])]


def replay(m: dict, seed: int, steps: Sequence[dict], prompts: Dict[int, list],
           served: Dict[int, list], judged: Sequence[int], n_slots: int,
           max_len: int, device, control: bool = False) -> Judged:
    """The engine's schedule again: ``steps`` in order, each
    ``{"admit": [[uid, slot], ...], "decode": bool}``; a decode step runs
    every slot's row, each of which must hold a request with a served
    token to come.  Tokens of the requests ``judged`` are judged."""
    _setup()
    dense = W.dense_leaves(m, seed, device)
    precs = ["f32"] + (["fp8"] if control else [])
    layers = {p: [Layer(m, seed, i, dense, device, p)
                  for i in range(m["n_layers"])] for p in precs}
    heads = {p: head(m, dense, p) for p in precs}
    emb, fnorm = dense["embed"].float(), dense["final_norm"].float()
    caches = {p: Slots(m, n_slots, max_len, device) for p in precs}
    uid_of: List[Optional[int]] = [None] * n_slots
    length = [0] * n_slots
    fed = [0] * n_slots             # served tokens of the slot's request fed
    judged = set(judged)
    out = Judged()

    def logits(p, x):
        return linear(rms(x, fnorm, m["norm_eps"]), heads[p], p)

    def judge(uids, ks, rows):
        sel = [j for j, u in enumerate(uids) if u in judged]
        if not sel:
            return
        toks = torch.as_tensor([served[uids[j]][ks[j]] for j in sel],
                               device=device)
        out.add(*_gaps(rows["f32"][sel], toks,
                       rows["fp8"][sel] if control else None))

    for step in steps:
        for uid, slot in step["admit"]:
            t = torch.as_tensor(prompts[uid], device=device)
            S = t.numel()
            rows = {}
            for p in precs:
                h = emb[t]
                pos = torch.arange(S, device=device)
                for i, layer in enumerate(layers[p]):
                    w = layer.w
                    q, k, v = layer.qkv(rms(h, w["ln1"], m["norm_eps"]), pos)
                    caches[p].k[i][slot, :S] = k
                    caches[p].v[i][slot, :S] = v
                    a = attend(q[None], k[None], v[None], pos[None],
                               torch.tensor([S], device=device))[0]
                    h = h + linear(a.flatten(-2), w["o"], p)
                    h = h + layer.mlp(rms(h, w["ln2"], m["norm_eps"]))
                rows[p] = logits(p, h[-1:])
            uid_of[slot], length[slot], fed[slot] = uid, S, 0
            judge([uid], [0], rows)
        if not step["decode"]:
            continue
        if any(u is None or fed[s] + 1 >= len(served[u])
               for s, u in enumerate(uid_of)):
            raise ReplayMismatch(
                "a decode step ran a slot with no request or no served "
                "token to come")
        tok = torch.as_tensor([served[u][fed[s]] for s, u in
                               enumerate(uid_of)], device=device)
        pos = torch.as_tensor(length, device=device)
        filled = max(length) + 1        # no slot's key lies past this one
        rows = {}
        for p in precs:
            h = emb[tok][:, None]                           # (B, 1, D)
            for i, layer in enumerate(layers[p]):
                w = layer.w
                q, k, v = layer.qkv(rms(h, w["ln1"], m["norm_eps"]),
                                    pos[:, None])
                ar = torch.arange(n_slots, device=device)
                caches[p].k[i][ar, pos] = k[:, 0]
                caches[p].v[i][ar, pos] = v[:, 0]
                a = attend(q, caches[p].k[i][:, :filled],
                           caches[p].v[i][:, :filled], pos[:, None], pos + 1)
                h = h + linear(a.flatten(-2), w["o"], p)
                h = h + layer.mlp(rms(h, w["ln2"], m["norm_eps"])[:, 0]
                                  )[:, None]
            rows[p] = logits(p, h[:, 0])
        ks = [fed[s] + 1 for s in range(n_slots)]
        judge(uid_of, ks, rows)
        for s, u in enumerate(uid_of):
            fed[s] += 1
            length[s] += 1
            if fed[s] + 1 == len(served[u]):
                uid_of[s] = None        # retired: its last token came
    return out


class ReplayMismatch(RuntimeError):
    """The recorded schedule cannot be what the engine ran."""
