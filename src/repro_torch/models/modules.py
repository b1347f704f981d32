"""Primitives of the model families (port of ``repro.models.modules``):
the quantization-aware dense layer, norms, embedding and initializers.

A ``Dense`` kernel is either a dense ``(in, out)`` tensor (``x @ W``
through ``torch.matmul``) or a CLAQ ``QuantizedTensor`` /
``PreparedQuantizedTensor`` in paper layout ``(out, in)``, which routes
through ``kernels.ops.qmatmul`` — the dequant-GEMM kernel on CUDA, its
plain version on CPU.  Calibration taps and ``QuantMode`` belong to the
quantizer, which is not ported yet.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch import nn

from repro_torch.core.quantized import QuantizedTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.plan import PreparedQuantizedTensor

_QUANTIZED = (QuantizedTensor, PreparedQuantizedTensor)


class Dense(nn.Module):
    """y = x @ kernel (+ bias).  Weights are buffers: serving needs no
    gradients."""

    def __init__(self, kernel, bias: Optional[torch.Tensor] = None):
        super().__init__()
        if isinstance(kernel, torch.Tensor):
            self.register_buffer("kernel", kernel)
        else:
            self.kernel = kernel
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    kernel = p.kernel
    if isinstance(kernel, _QUANTIZED):
        y = kops.qmatmul(x, kernel, use_kernel=True)
    else:
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
