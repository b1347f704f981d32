"""K1: the fused CLAQ dequant GEMM (port of ``repro.kernels.dequant_matmul``).

``dequant_matmul`` computes ``y = [acc +] x_tile @ W^T`` for ONE
uniform-bit-width group of a prepared plan (kernels/plan.py), with W
rebuilt from packed code planes, a per-column codebook and reserved
outliers.  ``x_mode`` says how the x tile is taken from ``x``:

  * "blocked":  x is already in the group's fused, padded K order;
  * "aligned":  x is the raw activation; fused column k is raw column
    ``x_start + k``, and the padded tail past ``k_cols`` reads as 0;
  * "gathered": x is the raw activation; fused column k is raw column
    ``x_idx[k]`` (flattened table), and index ``== x.shape[1]`` reads as 0.

x is f32, bf16 or int8.  An optional (M, 1) f32 ``x_scale`` multiplies
each output row once, after the whole K sum and the ``acc`` seed (K1e:
per-token int8 activations; a prepared matmul passes it to the last
group's launch only).

For a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/dequant_matmul.cu``, built at first use) or raises; for a CPU
tensor it runs ``dequant_matmul_plain``, the torch-eager version of the
same function.  It never falls back from the kernel to the plain version.

``launch_count`` counts kernel launches (CUDA only), and
``int8_launch_count`` those of them that read int8 x (K1e); ``plain_count``
counts dispatches to the plain version for CPU tensors.  A matmul over a
prepared plan adds one per distinct bit-width to one of them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core import packing

from . import cuda_build, ref

launch_count = 0
int8_launch_count = 0
plain_count = 0

_X_MODES = {"blocked": 0, "aligned": 1, "gathered": 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("dequant_matmul.cu").lib.claq_dequant_matmul
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, I, I,       # x, x_type, x_scale, M, x_cols
                       P, P, I, I, I,       # planes, widths, nplanes
                       P, I,                # codebook, levels
                       P, P, I,             # out_idx, out_val, k_out
                       P, P, P,             # acc, x_idx, out
                       I, I, I, I, I, I,    # n, k_padded, mode, start, k_cols, bf16
                       P]                   # stream
        fn.restype = I
        _FN = fn
    return _FN


def _check(x, planes, codebook, out_idx, out_val, bits, n, acc, x_mode,
           x_start, k_cols, x_idx, x_scale):
    """Shape/dtype validation shared by both paths."""
    if x.dtype not in _X_TYPES or x.dim() != 2:
        raise TypeError(f"x must be a 2-D f32/bf16/int8 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x_scale is not None and (x_scale.dtype != torch.float32
                                or tuple(x_scale.shape) != (x.shape[0], 1)):
        raise ValueError(f"x_scale must be ({x.shape[0]}, 1) f32, got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}")
    if x_mode not in _X_MODES:
        raise ValueError(f"unknown x_mode {x_mode!r}")
    widths = packing.plane_widths(bits)
    k_padded = codebook.shape[0]
    if len(planes) != len(widths):
        raise ValueError(f"{bits}-bit group needs {len(widths)} planes")
    for w, p in zip(widths, planes):
        if tuple(p.shape) != (n // (32 // w), k_padded):
            raise ValueError(f"plane shape {tuple(p.shape)} != "
                             f"{(n // (32 // w), k_padded)}")
    if tuple(codebook.shape) != (k_padded, 2 ** bits):
        raise ValueError(f"codebook shape {tuple(codebook.shape)}")
    if (out_idx is None) != (out_val is None) or (
            out_idx is not None and (out_idx.shape != out_val.shape
                                     or out_idx.shape[1] != k_padded)):
        raise ValueError("out_idx/out_val must both be (k_out, k_padded)")
    if acc is not None and tuple(acc.shape) != (x.shape[0], n):
        raise ValueError(f"acc shape {tuple(acc.shape)} != "
                         f"{(x.shape[0], n)}")
    if x_mode == "blocked" and x.shape[1] != k_padded:
        raise ValueError(f"blocked x needs {k_padded} columns, got "
                         f"{x.shape[1]}")
    if x_mode == "aligned" and not (0 <= x_start and k_cols <= k_padded
                                    and x_start + k_cols <= x.shape[1]):
        raise ValueError(f"aligned x reads columns [{x_start}, "
                         f"{x_start + k_cols}) of {x.shape[1]} "
                         f"(k_padded {k_padded})")
    if x_mode == "gathered" and (x_idx is None or x_idx.numel() != k_padded):
        raise ValueError("gathered x needs an x_idx table of k_padded "
                         "entries")


def dequant_matmul(
    x: torch.Tensor,                  # (M, K) blocked or raw, f32/bf16/i8
    planes: Sequence[torch.Tensor],   # per plane (n // cpw, k_padded) int32
    codebook: torch.Tensor,           # (k_padded, 2**bits) f32
    out_idx: Optional[torch.Tensor],  # (k_out, k_padded) int32, -1 = none
    out_val: Optional[torch.Tensor],  # (k_out, k_padded) f32
    *,
    bits: int,
    n: int,                           # padded N (rows of W)
    compute_dtype=torch.float32,
    acc: Optional[torch.Tensor] = None,     # (M, n) f32 running sum
    x_mode: str = "blocked",
    x_start: int = 0,                 # aligned: first raw column
    k_cols: int = 0,                  # aligned: unpadded fused K
    x_idx: Optional[torch.Tensor] = None,   # gathered: (k_padded/bk, bk)
    x_scale: Optional[torch.Tensor] = None,  # (M, 1) f32 per-token scale
) -> torch.Tensor:
    """y (M, n) f32 = ([acc +] x_tile @ W^T) [* x_scale] for one CLAQ
    group (see module docstring).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    global launch_count, int8_launch_count, plain_count
    _check(x, planes, codebook, out_idx, out_val, bits, n, acc, x_mode,
           x_start, k_cols, x_idx, x_scale)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be f32 or bf16, got "
                        f"{compute_dtype}")
    if not x.is_cuda:
        plain_count += 1
        return dequant_matmul_plain(
            x, planes, codebook, out_idx, out_val, bits=bits, n=n,
            compute_dtype=compute_dtype, acc=acc, x_mode=x_mode,
            x_start=x_start, k_cols=k_cols, x_idx=x_idx, x_scale=x_scale)

    k_padded = codebook.shape[0]
    if n % 32 or k_padded % 64:
        raise ValueError(f"the kernel needs n % 32 == 0 and k_padded % 64 "
                         f"== 0, got n={n}, k_padded={k_padded}")
    expect = [(x, x.dtype), (codebook, torch.float32)]
    expect += [(p, torch.int32) for p in planes]
    if out_idx is not None:
        expect += [(out_idx, torch.int32), (out_val, torch.float32)]
    if acc is not None:
        expect.append((acc, torch.float32))
    if x_mode == "gathered":
        expect.append((x_idx, torch.int32))
    if x_scale is not None:
        expect.append((x_scale, torch.float32))
    for t, dt in expect:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"operand dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands only")

    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    widths = packing.plane_widths(bits)
    k_out = 0 if out_idx is None else out_idx.shape[0]
    rc = _kernel_fn()(
        x.data_ptr(), _X_TYPES[x.dtype],
        x_scale.data_ptr() if x_scale is not None else None, m, x.shape[1],
        planes[0].data_ptr(),
        planes[1].data_ptr() if len(planes) > 1 else None,
        widths[0], widths[1] if len(widths) > 1 else 0, len(widths),
        codebook.data_ptr(), 2 ** bits,
        out_idx.data_ptr() if k_out else None,
        out_val.data_ptr() if k_out else None, k_out,
        acc.data_ptr() if acc is not None else None,
        x_idx.data_ptr() if x_mode == "gathered" else None,
        out.data_ptr(), n, k_padded, _X_MODES[x_mode], x_start, k_cols,
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    launch_count += 1
    int8_launch_count += x.dtype == torch.int8
    return out


def take_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last axis, 0.0 where idx == x.shape[-1] (the
    counterpart of ``jnp.take(..., mode="fill", fill_value=0)``)."""
    cols = x.shape[-1]
    idx = idx.long()
    xt = x[..., idx.clamp(max=cols - 1)]
    return torch.where(idx < cols, xt, torch.zeros_like(xt))


def dequant_matmul_plain(
    x, planes, codebook, out_idx, out_val, *, bits, n,
    compute_dtype=torch.float32, acc=None, x_mode="blocked", x_start=0,
    k_cols=0, x_idx=None, x_scale=None,
) -> torch.Tensor:
    """Torch-eager version of the kernel, same signature and semantics:
    materialize the x tile and W, override outliers in slot order, round
    both to ``compute_dtype``, multiply in f32, add ``acc``, then scale
    each row by ``x_scale``."""
    _check(x, planes, codebook, out_idx, out_val, bits, n, acc, x_mode,
           x_start, k_cols, x_idx, x_scale)
    k_padded = codebook.shape[0]
    if x_mode == "blocked":
        xt = x
    elif x_mode == "aligned":
        xt = x.new_zeros((x.shape[0], k_padded))
        xt[:, :k_cols] = x[:, x_start:x_start + k_cols]
    else:
        xt = take_fill(x, x_idx.reshape(-1))

    # rounding each element commutes with overriding it, so rounding after
    # the override matches the kernel, which rounds lookups and outliers
    W = ref.ref_apply_outliers(ref.ref_dequant_planes(planes, codebook,
                                                      bits, n),
                               out_idx, out_val).to(compute_dtype)
    y = xt.to(compute_dtype).float() @ W.float().T
    if acc is not None:
        y = acc + y
    return y if x_scale is None else y * x_scale
