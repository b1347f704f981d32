"""Primitives of the model families (port of ``repro.models.modules``):
the quantization-aware dense layer, calibration taps, norms, embedding and
initializers.

A ``Dense`` kernel is either a dense ``(in, out)`` tensor (``x @ W``
through ``torch.matmul``) or a CLAQ ``QuantizedTensor`` /
``PreparedQuantizedTensor`` in paper layout ``(out, in)``, which routes
through ``kernels.ops.qmatmul`` — the dequant-GEMM kernel on CUDA, its
plain version on CPU.  Two concerns are threaded through thread-local
context, as in the reference:

  * **Taps**: under ``collecting(collector, model)`` a dense ``Dense``
    streams its input into a per-matrix Hessian accumulator (H += 2 x^T x),
    keyed by the reference's tap names (``layers.{i}.attn.q``,
    ``enc.{i}.attn.q``, ``lm_head``; a MoE layer's experts
    ``layers.{i}.mlp.expert_in_{e}``; a shared block under ``tap_scope``
    once a site, ``shared_attn.site{s}.q``), so Hessian dicts of both
    packages compare key for key.
  * **Activation quantization**: ``activation_quant("int8")`` opts every
    quantized matmul into per-token int8 activations (``QuantMode``).

On a mesh (``dist.sharding.place_model``) a tensor may be this rank's
block along "model" (``_model_shard``); the primitives below then return
the replicated result through all-gathers, never through a sum of partial
products: a kernel (split on its output dim) multiplies locally and
gathers the columns, a vector (norm scale, bias) applies to this rank's
slice of the activation (a layer norm's scale and bias together), and a
vocab-split embedding looks up its own rows and sums over ranks with one
non-zero term.  Under a gradient the same calls differentiate
(``dist.collectives``): the replicated input of each sharded product
goes through ``collectives.replicated``, whose backward sums the ranks'
partial input gradients over "model".
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core import gptq
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops as kops
from repro_torch.kernels.plan import PreparedQuantizedTensor

_QUANTIZED = (QuantizedTensor, PreparedQuantizedTensor)

_STATE = threading.local()


# ---------------------------------------------------------------------------
# Calibration taps
# ---------------------------------------------------------------------------

_TAP_HEADS = {"blocks": "layers", "enc_blocks": "enc", "dec_blocks": "dec"}


def tap_name(module_name: str) -> str:
    """The reference's tap name of a module path: the port's
    ``blocks.{i}.attn.q`` is the reference's scope ``layers.{i}.attn.q``
    (``enc_blocks.{i}`` / ``dec_blocks.{i}`` are ``enc.{i}`` /
    ``dec.{i}``); ``lm_head`` stays."""
    head, _, rest = module_name.partition(".")
    if head in _TAP_HEADS and rest:
        return f"{_TAP_HEADS[head]}.{rest}"
    return module_name


class TapCollector:
    """Streams dense() inputs into per-matrix Hessian accumulators."""

    def __init__(self):
        self.hessians: Dict[str, gptq.HessianState] = {}
        self.names: Dict[int, str] = {}     # id(module) -> tap name

    def record(self, name: str, x: torch.Tensor) -> None:
        st = self.hessians.get(name)
        if st is None:
            st = gptq.init_hessian(x.shape[-1], device=x.device)
        self.hessians[name] = gptq.accumulate_hessian(st, x)

    def finalized(self) -> Dict[str, torch.Tensor]:
        return {k: gptq.finalize_hessian(v) for k, v in self.hessians.items()}


@contextlib.contextmanager
def collecting(collector: TapCollector, model: nn.Module):
    """Tap every ``Dense`` of ``model`` into ``collector`` while the
    context is open."""
    collector.names = {id(m): tap_name(n) for n, m in model.named_modules()}
    prev = getattr(_STATE, "collector", None)
    _STATE.collector = collector
    try:
        yield collector
    finally:
        _STATE.collector = prev


@contextlib.contextmanager
def tap_scope(prefix: str):
    """Name the taps recorded inside ``{prefix}.{leaf}``, ``leaf`` the
    last part of the module's own tap name: one block called at several
    sites (the hybrid's shared attention) taps once a site, as the
    reference's per-site scope names it."""
    prev = getattr(_STATE, "prefix", None)
    _STATE.prefix = prefix
    try:
        yield
    finally:
        _STATE.prefix = prev


@contextlib.contextmanager
def no_taps():
    """Record no taps inside (matmuls the reference's taps never see)."""
    prev = getattr(_STATE, "collector", None)
    _STATE.collector = None
    try:
        yield
    finally:
        _STATE.collector = prev


def _maybe_record(p, x: torch.Tensor) -> None:
    """Record ``x`` under ``p``'s tap name (``p`` a tapped ``Dense``, or a
    tap name) when a collector is open."""
    col: Optional[TapCollector] = getattr(_STATE, "collector", None)
    if col is None:
        return
    name = p if isinstance(p, str) else col.names.get(id(p))
    if name is None:
        return
    prefix = getattr(_STATE, "prefix", None)
    if prefix is not None:
        name = f"{prefix}.{name.rsplit('.', 1)[-1]}"
    col.record(name, x)


def record_expert_inputs(p: nn.Module, name: str, x_e: torch.Tensor) -> None:
    """MoE calibration taps: x_e (G, E, cap, D) dispatched activations of
    the MoE module ``p``.  One Hessian per expert (the tokens routed to
    it), named ``{p's tap name}.{name}_{e}`` (``layers.{i}.mlp.
    expert_in_{e}``) as in the reference."""
    col: Optional[TapCollector] = getattr(_STATE, "collector", None)
    base = None if col is None else col.names.get(id(p))
    if base is None:
        return
    for e in range(x_e.shape[1]):
        col.record(f"{base}.{name}_{e}", x_e[:, e].reshape(-1, x_e.shape[-1]))


# ---------------------------------------------------------------------------
# Quantized-matmul runtime mode
# ---------------------------------------------------------------------------

class QuantMode:
    """``act_dtype`` opts quantized matmuls into per-token int8 activation
    quantization ("int8"; None/"f32" = full precision), an engine-level
    deployment knob read inside dense().  The port always takes the kernel
    path (the reference's ``mode="kernel"``): the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors."""
    act_dtype: Optional[str] = None


@contextlib.contextmanager
def activation_quant(act_dtype: Optional[str]):
    """Scope the activation quantization mode (the ServingEngine wraps its
    prefill and decode with this)."""
    prev = QuantMode.act_dtype
    QuantMode.act_dtype = act_dtype
    try:
        yield
    finally:
        QuantMode.act_dtype = prev


class Dense(nn.Module):
    """y = x @ kernel (+ bias).  Weights are buffers: serving needs no
    gradients."""

    def __init__(self, kernel, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.set_kernel(kernel)
        self.register_buffer("bias", bias)

    def set_kernel(self, kernel) -> None:
        """Install ``kernel``: a dense tensor as a buffer, a CLAQ tensor or
        plan as a plain attribute (the quantizer swaps one for the
        other)."""
        self._buffers.pop("kernel", None)
        self.__dict__.pop("kernel", None)
        if isinstance(kernel, torch.Tensor):
            self.register_buffer("kernel", kernel)
        else:
            self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


def dense(p: Dense, x: torch.Tensor, tap: Optional[str] = None
          ) -> torch.Tensor:
    """y = x @ kernel (+ bias).  Quantized kernels take the fused
    one-launch-per-bit-width path with ``QuantMode.act_dtype``; dense ones
    feed the calibration taps, under ``tap`` when given (a second use of
    one matrix the reference taps under its own name) or ``p``'s name."""
    kernel = p.kernel
    if isinstance(kernel, _QUANTIZED):
        y = kops.qmatmul(x, kernel, use_kernel=True,
                         act_dtype=QuantMode.act_dtype)
    else:
        _maybe_record(p if tap is None else tap, x)
        y = linear(x, kernel)
    if p.bias is not None:
        y = coll.elementwise(y, p.bias,
                             lambda a, b: a + b.to(a.dtype))
    return y


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a dense (in, out) ``w``: a placed ``w`` gives this
    rank's output columns (placement never splits the input dim: see
    ``dist.sharding.place_model``), all-gathered."""
    if out_block(w) is None:
        return x @ w.to(x.dtype)
    return gather_out(coll.replicated(x) @ w.to(x.dtype), w)


class OutBlock(NamedTuple):
    """A placed kernel's out block: its ``width`` (a CLAQ plan's padded
    rows), ``parts`` and ``index`` along "model", and the ``total`` out
    dim of the whole kernel."""
    width: int
    parts: int
    index: int
    total: int


def out_block(kernel) -> Optional[OutBlock]:
    """This rank's out block of a kernel placed over "model" (a
    shard-local CLAQ plan or stack, or a dense ``(..., in, out)`` tensor
    split on ``out``: placement never splits a contraction dim), else
    None."""
    if isinstance(kernel, _QUANTIZED):
        sh = getattr(kernel, "shard", None)
        return None if sh is None else OutBlock(kernel.n_padded, sh.parts,
                                                sh.index, sh.rows)
    sh = coll.model_shard(kernel)
    if sh is None:
        return None
    n = kernel.shape[-1]
    return OutBlock(n, sh[1], sh[2], n * sh[1])


def gather_out(y: torch.Tensor, kernel) -> torch.Tensor:
    """``y`` (..., out block), a product of a placed kernel's own out
    block, all-gathered over "model" into the kernel's whole out dim (a
    CLAQ plan's padding dropped); ``y`` itself for a whole kernel."""
    if out_block(kernel) is None:
        return y
    if isinstance(kernel, _QUANTIZED):
        return kops.gather_shards(y, kernel)
    return coll.all_gather(y, dim=-1)


def materialize_kernel(p: Dense) -> torch.Tensor:
    """The kernel as a dense (in, out) tensor, dequantized (to bf16, as in
    the reference) if quantized: for paths that need the weight itself
    (MLA's absorbed decode)."""
    kernel = p.kernel
    if isinstance(kernel, _QUANTIZED):
        return kernel.dequantize(torch.bfloat16).T
    return kernel


def module_tensors(module: nn.Module) -> Iterator[torch.Tensor]:
    """Every tensor a model holds: buffers, parameters, and the leaves of
    its quantized kernels."""
    yield from module.buffers()
    yield from module.parameters()
    for m in module.modules():
        kernel = getattr(m, "kernel", None)
        if isinstance(kernel, _QUANTIZED):
            yield from kernel.tensors()


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return coll.elementwise(y, scale, lambda a, s: a * s.float()).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    # a placed scale and bias are the same block of the feature axis
    assert coll.model_shard(scale) == coll.model_shard(bias)
    return coll.elementwise(
        y, scale, lambda a, s: a * s.float() + bias.float()).to(x.dtype)


def embed(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embedding`` at ``tokens``, through ``F.embedding``: its
    backward sums a repeated token's rows in a fixed order on the CPU,
    where indexing's accumulating scatter does not (training would not
    repeat itself bitwise)."""
    sh = coll.model_shard(embedding)
    if sh is None:
        return nn.functional.embedding(tokens.long(), embedding)
    dim, _, index = sh
    if dim == 1:
        return coll.all_gather(nn.functional.embedding(tokens.long(),
                                                       embedding), dim=-1)
    n = embedding.shape[0]
    local = tokens.long() - index * n
    ok = (local >= 0) & (local < n)
    rows = nn.functional.embedding(torch.where(ok, local, 0), embedding)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return coll.sum_one_nonzero(rows)


def tied_logits(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """``x @ embedding^T`` (tied embeddings): a vocab-split embedding
    gives this rank's logit columns, all-gathered (placement splits a tied
    embedding over vocab only)."""
    if coll.model_shard(embedding) is None:
        return x @ embedding.to(x.dtype).T
    return coll.all_gather(coll.replicated(x) @ embedding.to(x.dtype).T,
                           dim=-1)


# ---------------------------------------------------------------------------
# Initializers (explicit generators)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, dtype=torch.float32, device=None,
               scale: Optional[float] = None) -> Dense:
    if scale is None:
        scale = in_dim ** -0.5
    k = torch.randn((in_dim, out_dim), generator=gen, device=device,
                    dtype=torch.float32) * scale
    b = torch.zeros((out_dim,), dtype=dtype, device=device) if bias else None
    return Dense(k.to(dtype), b)


def norm_scale_init(dim: int, dtype=torch.float32, device=None):
    return torch.ones((dim,), dtype=dtype, device=device)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)
