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
    ``lm_head``), so Hessian dicts of both packages compare key for key.
  * **Activation quantization**: ``activation_quant("int8")`` opts every
    quantized matmul into per-token int8 activations (``QuantMode``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from repro_torch.core import gptq
from repro_torch.core.quantized import QuantizedTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.plan import PreparedQuantizedTensor

_QUANTIZED = (QuantizedTensor, PreparedQuantizedTensor)

_STATE = threading.local()


# ---------------------------------------------------------------------------
# Calibration taps
# ---------------------------------------------------------------------------

def tap_name(module_name: str) -> str:
    """The reference's tap name of a module path: the port's
    ``blocks.{i}.attn.q`` is the reference's scope ``layers.{i}.attn.q``;
    ``lm_head`` stays."""
    head, _, rest = module_name.partition(".")
    return f"layers.{rest}" if head == "blocks" and rest else module_name


class TapCollector:
    """Streams dense() inputs into per-matrix Hessian accumulators."""

    def __init__(self):
        self.hessians: Dict[str, gptq.HessianState] = {}
        self.names: Dict[int, str] = {}     # id(Dense) -> tap name

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
    collector.names = {id(m): tap_name(n) for n, m in model.named_modules()
                       if isinstance(m, Dense)}
    prev = getattr(_STATE, "collector", None)
    _STATE.collector = collector
    try:
        yield collector
    finally:
        _STATE.collector = prev


def _maybe_record(p, x: torch.Tensor) -> None:
    """Record ``x`` under ``p``'s tap name (``p`` a tapped ``Dense``, or a
    tap name) when a collector is open."""
    col: Optional[TapCollector] = getattr(_STATE, "collector", None)
    if col is None:
        return
    name = p if isinstance(p, str) else col.names.get(id(p))
    if name is not None:
        col.record(name, x)


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


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """y = x @ kernel (+ bias).  Quantized kernels take the fused
    one-launch-per-bit-width path with ``QuantMode.act_dtype``; dense ones
    feed the calibration taps."""
    kernel = p.kernel
    if isinstance(kernel, _QUANTIZED):
        y = kops.qmatmul(x, kernel, use_kernel=True,
                         act_dtype=QuantMode.act_dtype)
    else:
        _maybe_record(p, x)
        y = x @ kernel.to(x.dtype)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


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
    return (y * scale.float()).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def embed(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens.long()]


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
