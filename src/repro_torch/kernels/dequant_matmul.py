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

``launch_plan`` picks the kernel's tile, its K slices and its workspace
from (M, n, k_padded, bits, compute type, k_out) and the card's SM count
alone; the wrapper hands it to the C function.  With more than one K slice
the wrapper allocates, for that launch alone, the (slices, M, n) f32
workspace of partial sums and one int32 arrival counter per output tile
(zeroed by the launch's own pre-pass), so launches on different streams
or in a CUDA graph never share state.

``launch_count`` counts wrapper calls that launch the kernel (CUDA only),
and ``int8_launch_count`` those of them that read int8 x (K1e);
``plain_count`` counts dispatches to the plain version for CPU tensors.  A
matmul over a prepared plan adds one per distinct bit-width to one of
them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import packing

from . import cuda_build, ref

launch_count = 0
int8_launch_count = 0
plain_count = 0

_X_MODES = {"blocked": 0, "aligned": 1, "gathered": 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FN = None
_SMS: Dict[torch.device, int] = {}

# the kernel's tiling and shared memory (csrc/dequant_common.cuh and
# dequant_kernels.cuh; tests/test_torch_k1_plan.py parses them from there)
BLOCK_N = 128             # output rows of a block tile
CHUNK_K = 64              # K columns of a pipeline stage
DECODE_MAX_M = 16         # M <= 16: the decode path; above: prefill
PREFILL_M = 64            # M rows of a prefill tile
DECODE_MAX_SLICE_CHUNKS = 16  # x of a decode slice is staged whole
STAGE_OUT = 8             # outlier slots staged per chunk (kStageOut)
WORD_PAD = 16             # words of padding per staged plane row
X_PAD = 16                # elements of padding per staged bf16 x row
SMEM_LEVELS = 16          # codebooks of <= 4 bits are staged
TILE_PITCH = BLOCK_N + 4  # f32 pitch of an output tile
STAGES = 3                # cp.async ring, both paths
FRAG_SCRATCH = 4 * 8 * 32 * 16   # bf16 W fragments of 4 warps
# the register side of residency: each kernel's __launch_bounds__ minimum
# blocks per SM, by block_m
LAUNCH_MIN_BLOCKS = {4: 4, 8: 4, 16: 3, PREFILL_M: 2}
# the shared memory side (Hopper): per SM, the most one block may opt in
# to, the driver's reserve per block, the allocation unit, and the
# kernels' static shared memory (rounded up)
SM_SMEM = 228 * 1024
BLOCK_SMEM_MAX = 227 * 1024
BLOCK_SMEM_RESERVED = 1024
SMEM_UNIT = 128
STATIC_SMEM = 16
N_SMS = 132               # H100 SXM, the default where no card is asked


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one kernel launch tiles its work: blocks of ``block_m`` x
    ``BLOCK_N`` outputs, each summing ``chunks_per_slice`` K chunks of
    ``CHUNK_K`` columns (the last slice may hold fewer)."""
    decode: bool
    block_m: int
    m_tiles: int
    n_tiles: int
    chunks: int
    chunks_per_slice: int
    slices: int
    workspace_elems: int      # f32 partial sums, 0 with one slice
    counters: int             # arrival counters, 0 with one slice
    x_elems: int              # x gathered once, in the compute type
    smem: int                 # dynamic shared memory of the product kernel
    blocks_per_sm: int        # its resident blocks (launch bounds, smem)

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.slices

    def slice_bounds(self) -> List[Tuple[int, int]]:
        """[k_lo, k_hi) of each K slice, in slice order."""
        k_padded = self.chunks * CHUNK_K
        step = self.chunks_per_slice * CHUNK_K
        return [(lo, min(lo + step, k_padded))
                for lo in range(0, k_padded, step)]


def _stage_bytes(bits: int, k_out: int) -> int:
    """One ring stage's W operands (csrc stage_layout): plane words with
    their row padding, the codebook rows if staged, the staged outlier
    slots' idx and val rows."""
    words = sum(BLOCK_N * w // 32 for w in packing.plane_widths(bits))
    levels = 2 ** bits
    return (words * (CHUNK_K + WORD_PAD) * 4
            + (CHUNK_K * levels * 4 if levels <= SMEM_LEVELS else 0)
            + 2 * min(k_out, STAGE_OUT) * CHUNK_K * 4)


def kernel_smem(bits: int, k_out: int, block_m: int, chunks_per_slice: int,
                bf16: bool) -> int:
    """Dynamic shared memory of the product kernel (csrc decode_smem and
    prefill_smem), in bytes."""
    stage = _stage_bytes(bits, k_out)
    item = 2 if bf16 else 4
    if block_m == PREFILL_M:
        x_pitch = CHUNK_K + (X_PAD if bf16 else 4)
        ring = STAGES * (stage + PREFILL_M * x_pitch * item)
        w = FRAG_SCRATCH if bf16 else CHUNK_K * (BLOCK_N + 1) * 4
        return max(ring + w, PREFILL_M * TILE_PITCH * 4)
    xs = block_m * (chunks_per_slice * CHUNK_K + X_PAD) * item
    used = -(-(STAGES * stage + xs) // 16) * 16 + (FRAG_SCRATCH if bf16
                                                   else 0)
    return max(used, 4 * block_m * TILE_PITCH * 4)


def resident_blocks(block_m: int, smem: int) -> int:
    """Blocks of the product kernel an SM holds: the fewer of its launch
    bounds' minimum and what its shared memory allows (0: it does not
    fit)."""
    if smem > BLOCK_SMEM_MAX:
        return 0
    per_block = (-(-(smem + STATIC_SMEM) // SMEM_UNIT) * SMEM_UNIT
                 + BLOCK_SMEM_RESERVED)
    return min(LAUNCH_MIN_BLOCKS[block_m], SM_SMEM // per_block)


@functools.lru_cache(maxsize=4096)      # every call of a serve repeats one
def launch_plan(m: int, n: int, k_padded: int, bits: int,
                compute_dtype=torch.float32, k_out: int = 0,
                sms: int = N_SMS) -> LaunchPlan:
    """The kernel's launch plan for an (m, n) output over k_padded columns
    of one ``bits``-wide group with ``k_out`` outlier slots, on a card of
    ``sms`` SMs.  M <= 16 takes the decode path (bf16: M padded to 8 or 16
    for mma.sync; f32: 4-row M tiles, at most ``DECODE_MAX_SLICE_CHUNKS``
    chunks a slice); larger M takes 64-row prefill tiles.  Both run after a
    pre-pass that gathers x once into fused K order (``x_elems`` of the
    compute type).  K is split into as many slices as keep the grid within
    one wave of resident blocks (``resident_blocks``, from the launch's
    shared memory, which grows with the slice at decode): the unpacking is
    latency-bound, so short slices that put more warps on each SM beat
    long ones.  It depends on nothing else (not on x_mode), so every x
    mode sums in the same order.  Raises ValueError for a shape the kernel
    does not take."""
    packing.plane_widths(bits)                   # raises on a bad width
    if m < 1 or n % 32 or k_padded % CHUNK_K or k_padded == 0 or k_out < 0:
        raise ValueError(f"the kernel needs m >= 1, n % 32 == 0, k_out >= 0 "
                         f"and k_padded a positive multiple of {CHUNK_K}, "
                         f"got m={m}, n={n}, k_padded={k_padded}, "
                         f"k_out={k_out}")
    decode = m <= DECODE_MAX_M
    bf16 = compute_dtype == torch.bfloat16
    if decode:
        block_m = (8 if m <= 8 else 16) if bf16 else 4
    else:
        block_m = PREFILL_M
    m_tiles = -(-m // block_m)
    n_tiles = -(-n // BLOCK_N)
    chunks = k_padded // CHUNK_K
    per_sm = LAUNCH_MIN_BLOCKS[block_m]
    while True:       # longer slices stage more x: fewer blocks may fit
        want = max(1, per_sm * sms // (m_tiles * n_tiles))
        cps = -(-chunks // want)
        if decode:
            cps = min(cps, DECODE_MAX_SLICE_CHUNKS)
        smem = kernel_smem(bits, k_out, block_m, cps, bf16)
        fit = resident_blocks(block_m, smem)
        if fit == 0:
            raise ValueError(f"the kernel's {smem} bytes of shared memory "
                             f"exceed the card's {BLOCK_SMEM_MAX} a block "
                             f"(m={m}, bits={bits}, k_out={k_out})")
        if fit >= per_sm:
            break
        per_sm = fit
    slices = -(-chunks // cps)
    split = slices > 1
    return LaunchPlan(decode=decode, block_m=block_m, m_tiles=m_tiles,
                      n_tiles=n_tiles, chunks=chunks, chunks_per_slice=cps,
                      slices=slices,
                      workspace_elems=slices * m * n if split else 0,
                      counters=m_tiles * n_tiles if split else 0,
                      x_elems=m * k_padded, smem=smem, blocks_per_sm=per_sm)


def _sm_count(device: torch.device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = sms
    return sms


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
                       I, I, P, P, P,       # block_m, chunks/slice, workspace,
                       #                      counters, gathered x
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
    k_out = 0 if out_idx is None else out_idx.shape[0]
    lp = launch_plan(x.shape[0], n, k_padded, bits, compute_dtype, k_out,
                     _sm_count(x.device))
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
    for t in (*planes, codebook, out_idx, out_val):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernel copies plan operands 16 bytes at "
                             "a time: they must be 16-byte aligned")

    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    widths = packing.plane_widths(bits)
    work = counters = None
    if lp.slices > 1:          # partial sums, then the arrival counters
        work = torch.empty(lp.workspace_elems + lp.counters,
                           dtype=torch.float32, device=x.device)
        counters = work[lp.workspace_elems:].view(torch.int32)
    xg = torch.empty(lp.x_elems, dtype=compute_dtype, device=x.device)
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
        int(compute_dtype == torch.bfloat16), lp.block_m,
        lp.chunks_per_slice,
        work.data_ptr() if work is not None else None,
        counters.data_ptr() if counters is not None else None,
        xg.data_ptr(),
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
