"""Bit-packing of quantization codes into 32-bit words (port of
``repro.core.packing``).

Codes are packed *along the row axis within each column*: one word holds
``32/width`` consecutive rows of one column, low bits first.  Widths
1/2/4/8 divide 32; 3-bit codes are two bit-planes (low 2 bits + high 1
bit, concatenated along the packed-row axis).

torch has no full uint32 arithmetic, so words are held as ``int32`` with
the same bits (cross from numpy with ``.view(np.int32)``).  Two
consequences shape the code below:

  * ``>>`` on int32 is an arithmetic shift, so every unpack masks AFTER
    the shift (the mask keeps only the field's own bits, whatever the
    sign bit spread into the high ones);
  * packing cannot sum the shifted fields in int32 (the top field reaches
    the sign bit), so the fields are ORed in int64 and the word is folded
    back into int32's range by two's complement.
"""
from __future__ import annotations

import torch

_PLANES = {1: (1,), 2: (2,), 3: (2, 1), 4: (4,), 8: (8,)}


def plane_widths(bits: int):
    if bits not in _PLANES:
        raise ValueError(f"unsupported bit-width {bits}")
    return _PLANES[bits]


def plane_rows(rows: int, width: int) -> int:
    cpw = 32 // width
    return (rows + cpw - 1) // cpw


def packed_rows(rows: int, bits: int) -> int:
    return sum(plane_rows(rows, w) for w in plane_widths(bits))


def _pack_plane(vals: torch.Tensor, width: int) -> torch.Tensor:
    cpw = 32 // width
    rows, cols = vals.shape
    pr = plane_rows(rows, width)
    v = torch.zeros((pr * cpw, cols), dtype=torch.int64, device=vals.device)
    v[:rows] = vals.to(torch.int64)
    v = v.reshape(pr, cpw, cols)
    word = torch.zeros((pr, cols), dtype=torch.int64, device=vals.device)
    for i in range(cpw):
        word |= v[:, i] << (i * width)
    # unsigned 32-bit value -> int32 with the same bits
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.to(torch.int32)


def _unpack_plane(words: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    cpw = 32 // width
    mask = (1 << width) - 1
    shifts = (torch.arange(cpw, dtype=torch.int32, device=words.device)
              * width)[:, None]
    v = (words[..., :, None, :] >> shifts).bitwise_and_(mask)  # after shift
    v = v.reshape(words.shape[:-2] + (words.shape[-2] * cpw,
                                      words.shape[-1]))
    return v[..., :rows, :].to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(rows, cols) int codes < 2**bits -> (packed_rows(rows, bits), cols)
    int32 words.  Multi-plane widths concatenate planes along the
    packed-row axis (low-order plane first)."""
    planes = []
    shift = 0
    for w in plane_widths(bits):
        planes.append(_pack_plane((codes >> shift) & ((1 << w) - 1), w))
        shift += w
    return planes[0] if len(planes) == 1 else torch.cat(planes, dim=0)


def unpack_codes(words: torch.Tensor, bits: int, rows: int) -> torch.Tensor:
    """(..., packed_rows, cols) int32 words -> (..., rows, cols) int32 codes
    (leading axes: a stack of matrices, e.g. MoE experts)."""
    return unpack_planes(split_planes(words, bits, rows), bits, rows)


def unpack_planes(planes, bits: int, rows: int) -> torch.Tensor:
    """Per-plane word arrays (low-order plane first, as ``split_planes``
    gives them; extra padded rows are ignored) -> (..., rows, cols) int32
    codes."""
    out = None
    shift = 0
    for w, p in zip(plane_widths(bits), planes):
        part = _unpack_plane(p, w, rows) << shift
        out = part if out is None else out | part
        shift += w
    return out


def split_planes(words: torch.Tensor, bits: int, rows: int):
    """Split a packed array into its per-plane arrays (for the kernel)."""
    parts = []
    r0 = 0
    for w in plane_widths(bits):
        pr = plane_rows(rows, w)
        parts.append(words[..., r0:r0 + pr, :])
        r0 += pr
    return tuple(parts)


def storage_bits_per_element(bits: int) -> float:
    """Effective storage cost per element (exact for rows % 32 == 0)."""
    return float(sum(plane_widths(bits)))
