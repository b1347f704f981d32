"""Dispatch of QuantizedTensor matmuls to the dequant-GEMM kernel (port of
``repro.kernels.ops``).

``qmatmul(x, qt)`` computes x @ dequantize(qt)^T for a QuantizedTensor or
a PreparedQuantizedTensor.  On a prepared plan it is one kernel launch per
distinct bit-width, chained through the kernel's ``acc`` operand; the
kernel path never materializes W.  ``act_dtype="int8"`` quantizes the
activations per token (``quantize_activations``) and folds the scales into
the last launch (prepared plans only).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.quantized import QuantizedTensor

from . import dequant_matmul as dm
from . import ref as ref_lib
from .plan import PreparedQuantizedTensor, round_up, validated_outliers


def quantize_activations(x: torch.Tensor):
    """Per-token (row) dynamic absmax int8 quantization: x (..., K) ->
    (xq (..., K) int8, scale (..., 1) f32) with x ~= xq * scale.  The absmax
    and ``absmax / 127`` are taken in x's own dtype (a bf16 division for a
    bf16 x), then the scale is cast to f32; all-zero rows get scale 1.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The error
    per element is <= scale / 2 (``ref.ref_act_int8_bound``)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0).float()
    xq = torch.round(x.float() / scale).to(torch.int8)
    return xq, scale


def normalize_act_dtype(act_dtype):
    """None/'f32' -> None (full precision); 'int8' passes through;
    anything else raises.  The one validation point of the knob; the
    ServingEngine calls it too."""
    if act_dtype in (None, "f32"):
        return None
    if act_dtype != "int8":
        raise ValueError(f"unsupported act_dtype {act_dtype!r} "
                         "(expected 'f32' or 'int8')")
    return act_dtype


def stripe_matmul(x: torch.Tensor, stripe_packed: torch.Tensor,
                  codebook: torch.Tensor, out_idx: Optional[torch.Tensor],
                  out_val: Optional[torch.Tensor], *, bits: int, n: int,
                  bk: int = 512, compute_dtype=torch.float32) -> torch.Tensor:
    """Single-stripe kernel call ("blocked" x) with all padding handled.
    x: (M, K) -> (M, n)."""
    k_dim = x.shape[1]
    bk = min(bk, round_up(k_dim, 128))
    k_padded = round_up(k_dim, bk)
    n_padded = round_up(n, 32)
    xp = F.pad(x, (0, k_padded - k_dim)).contiguous()
    planes = []
    for w, p in zip(packing.plane_widths(bits),
                    packing.split_planes(stripe_packed, bits, n)):
        rows = n_padded // (32 // w)
        planes.append(F.pad(p, (0, k_padded - k_dim, 0,
                                rows - p.shape[0])).contiguous())
    cb = F.pad(codebook.float(), (0, 0, 0, k_padded - k_dim)).contiguous()
    oi = ov = None
    if out_idx is not None and out_idx.shape[0] > 0:
        oi = F.pad(out_idx.to(torch.int32), (0, k_padded - k_dim),
                   value=-1).contiguous()
        ov = F.pad(out_val.float(), (0, k_padded - k_dim)).contiguous()
    y = dm.dequant_matmul(xp, tuple(planes), cb, oi, ov, bits=bits,
                          n=n_padded, compute_dtype=compute_dtype)
    return y[:, :n]


def group_calls(x2: torch.Tensor, pqt: PreparedQuantizedTensor,
                gather: str = "kernel",
                x_scale: Optional[torch.Tensor] = None,
                ) -> Iterator[Tuple[torch.Tensor, dict]]:
    """The (x operand, keyword arguments) of each kernel launch of a
    prepared matmul, in the plan's ascending bit order.  x2: (M, K).

    gather="kernel": the kernel reads RAW x — "aligned" groups at their
    static column offset, "gathered" groups through their x_idx tables;
    ``x_scale`` (int8 activations) rides the LAST launch only.
    gather="xla": x is gathered once into fused, padded K order and every
    group runs "blocked" on its slice (the A/B path; bitwise equal); the
    caller applies ``x_scale`` after the last launch, so it is not passed."""
    if gather == "xla":
        xg = dm.take_fill(x2, pqt.gather_idx)
        off = 0
        for g in pqt.groups:
            yield xg[:, off:off + g.k_padded].contiguous(), dict(
                planes=g.planes, codebook=g.codebook, out_idx=g.out_idx,
                out_val=g.out_val, bits=g.bits, n=pqt.n_padded,
                x_mode="blocked")
            off += g.k_padded
    elif gather == "kernel":
        last = len(pqt.groups) - 1
        for gi, g in enumerate(pqt.groups):
            aligned = g.x_start is not None
            yield x2, dict(
                planes=g.planes, codebook=g.codebook, out_idx=g.out_idx,
                out_val=g.out_val, bits=g.bits, n=pqt.n_padded,
                x_mode="aligned" if aligned else "gathered",
                x_start=g.x_start if aligned else 0, k_cols=g.k_cols,
                x_idx=g.x_idx, x_scale=x_scale if gi == last else None)
    else:
        raise ValueError(f"unknown gather mode {gather!r} "
                         "(expected 'kernel' or 'xla')")


def prepared_qmatmul(x: torch.Tensor, pqt: PreparedQuantizedTensor, *,
                     compute_dtype=torch.float32, gather: str = "kernel",
                     act_dtype=None) -> torch.Tensor:
    """Hot path: x (..., K) @ dequantize(pqt)^T -> (..., N), in x's dtype.
    One kernel launch per distinct bit-width, each seeding its output with
    the previous group's (``acc``).  act_dtype="int8" quantizes x per token
    in x's own dtype; the kernel reads int8 x and the last launch applies
    the (M, 1) scales (gather="xla": one multiply after the last launch —
    bitwise the same)."""
    act_dtype = normalize_act_dtype(act_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    scale = None
    if act_dtype == "int8":
        x2, scale = quantize_activations(x2)
    y = None
    for xg, kw in group_calls(x2, pqt, gather, x_scale=scale):
        y = dm.dequant_matmul(xg, acc=y, compute_dtype=compute_dtype, **kw)
    y = y[:, :pqt.rows]
    if scale is not None and gather == "xla":
        y = y * scale
    return y.reshape(lead + (pqt.rows,)).to(x.dtype)


def _prepared_ref_qmatmul(x: torch.Tensor, pqt: PreparedQuantizedTensor,
                          act_dtype=None) -> torch.Tensor:
    """Eager path over the prepared layout: gather x into fused order, then
    a per-group dequant + f32 product over each group's unpadded K.
    act_dtype="int8" quantizes x AFTER the cast to f32 (unlike the kernel
    path, which quantizes in x's dtype), multiplies the int8-exact values
    and applies the scales at the end."""
    rows = pqt.rows
    xf = x.float()
    scale = None
    if normalize_act_dtype(act_dtype) == "int8":
        xq, scale = quantize_activations(xf)
        xf = xq.float()
    xg = dm.take_fill(xf, pqt.gather_idx)
    y = torch.zeros(x.shape[:-1] + (rows,), dtype=torch.float32,
                    device=x.device)
    off = 0
    for g in pqt.groups:
        Wg = ref_lib.ref_apply_outliers(
            ref_lib.ref_dequant_planes(g.planes, g.codebook, g.bits, rows),
            g.out_idx, g.out_val)
        xs = xg[..., off:off + g.k_cols]
        y = y + xs @ Wg[:, :g.k_cols].T
        off += g.k_padded
    return y if scale is None else y * scale


def qmatmul(x: torch.Tensor, qt, *, use_kernel: bool = False,
            compute_dtype=None, act_dtype=None,
            gather: str = "kernel") -> torch.Tensor:
    """x (..., K) @ dequantize(qt)^T -> (..., N) for a QuantizedTensor or a
    PreparedQuantizedTensor, in x's dtype.

    use_kernel=False: the eager reference path.  use_kernel=True: the
    dequant-GEMM (kernel on CUDA, its plain version on CPU); prepared plans
    take the fused path, one launch per distinct bit-width.  Computes in
    bf16 unless x is f32.  act_dtype="int8" needs a prepared plan."""
    if compute_dtype is None:
        compute_dtype = (torch.float32 if x.dtype == torch.float32
                         else torch.bfloat16)
    if isinstance(qt, PreparedQuantizedTensor):
        if not use_kernel:
            return _prepared_ref_qmatmul(x, qt, act_dtype).to(x.dtype)
        return prepared_qmatmul(x, qt, compute_dtype=compute_dtype,
                                gather=gather, act_dtype=act_dtype)
    if normalize_act_dtype(act_dtype) is not None:
        raise ValueError(
            "act_dtype quantization needs an ahead-of-time plan — prepare "
            "the tensor first (plan.prepare_for_inference / prepare_tree; "
            "ServingEngine does this at init unless prepare=False)")
    if not use_kernel:
        return ref_lib.ref_qmatmul(x, qt).to(x.dtype)

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xp = x2[:, qt.col_perm.long()]              # stripe order
    oi, ov = validated_outliers(qt)
    y = torch.zeros((x2.shape[0], qt.rows), dtype=torch.float32,
                    device=x.device)
    off = 0
    for s in qt.stripes:
        nc = s.n_cols
        y = y + stripe_matmul(
            xp[:, off:off + nc], s.packed, s.codebook,
            None if oi is None else oi[:, off:off + nc],
            None if ov is None else ov[:, off:off + nc],
            bits=s.bits, n=qt.rows, compute_dtype=compute_dtype)
        off += nc
    return y.reshape(lead + (qt.rows,)).to(x.dtype)
