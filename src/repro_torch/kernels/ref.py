"""Pure-torch oracles for the kernels (port of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.quantized import QuantizedTensor


def ref_dequant_planes(planes, codebook: torch.Tensor, bits: int,
                       n: int) -> torch.Tensor:
    """Per-plane words (as ``packing.split_planes`` gives them) + codebook
    (K, 2**bits) -> W (n, K) f32.  The one codebook lookup that the plain
    kernel, the eager prepared path and the plan oracle share."""
    codes = packing.unpack_planes(planes, bits, n).long()
    return torch.gather(codebook.float().T, 0, codes)


def ref_dequant(packed: torch.Tensor, codebook: torch.Tensor, bits: int,
                n: int) -> torch.Tensor:
    """packed (packed_rows, K) + codebook (K, 2**bits) -> W (n, K)."""
    return ref_dequant_planes(packing.split_planes(packed, bits, n),
                              codebook, bits, n)


def ref_apply_outliers(W: torch.Tensor, out_idx: Optional[torch.Tensor],
                       out_val: Optional[torch.Tensor]) -> torch.Tensor:
    """Override W[idx[r,k], k] = val[r,k] where idx >= 0 (kernel semantics;
    a later slot wins)."""
    if out_idx is None or out_idx.shape[0] == 0:
        return W
    W = W.clone()
    for r in range(out_idx.shape[0]):
        hit = out_idx[r] >= 0
        W[out_idx[r][hit].long(), torch.nonzero(hit)[:, 0]] = \
            out_val[r][hit].to(W.dtype)
    return W


def ref_dequant_matmul(x: torch.Tensor, packed: torch.Tensor,
                       codebook: torch.Tensor,
                       out_idx: Optional[torch.Tensor],
                       out_val: Optional[torch.Tensor], *, bits: int,
                       n: int) -> torch.Tensor:
    """Oracle for one stripe: y = x @ W^T in f32."""
    W = ref_apply_outliers(ref_dequant(packed, codebook, bits, n),
                           out_idx, out_val)
    return x.float() @ W.T


def ref_qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Oracle for the full multi-stripe matmul: x @ dequantize(qt)^T."""
    return x.float() @ qt.dequantize(torch.float32).T


def ref_act_int8_bound(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Per-output-element error bound of the int8 activation path against
    f32: quantization moves each activation by at most scale/2 (absmax
    scaling never clips), so |dy[m, n]| <= scale_m / 2 * ||W[n, :]||_1.
    x (..., K), W (N, K) -> bound (..., N).  Quantization error only;
    callers add an epsilon for f32 summation order."""
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    return 0.5 * scale * W.float().abs().sum(dim=1)
