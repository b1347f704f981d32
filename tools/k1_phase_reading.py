#!/usr/bin/env python3
"""Where K1's time goes: build variants of the CUDA dequant GEMM with one
phase removed and time each on the main decode case, on one NVIDIA card.

    python3 tools/k1_phase_reading.py [--m 4 16]

Each variant is the source with one text replacement (a phase skipped or
replaced by a constant); the results are wrong and only their times count.
The variants are written under ``build/k1_reading/`` (gitignored) and never
kept.  Every variant runs the 3-launch (2/3/4-bit) gathered bf16 chain of a
synthetic llama1_7b plan (``chip_smoke.synthetic_qt``) at each shape and M,
after an L2 flush; the device time of each launch comes from
``torch.profiler``.  Prints one JSON line per (shape, M) and writes them to
``build/k1_reading/reading.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

from repro_torch.kernels import cuda_build  # noqa: E402

# (file, text, replacement) per variant of the kernel in csrc/
VARIANTS = {
    "no_outliers": [("dequant_common.cuh", "    k_out = a.k_out;",
                     "    k_out = 0;")],
    "staged_slots_only": [   # no device-memory path for slots past
        # kStageOut (the plans here have 3 or fewer): what that path costs
        ("dequant_common.cuh",
         "    for (int o = staged; o < k_out; ++o)  // past the stage: device "
         "memory\n      mark(__ldg(reinterpret_cast<const int4*>(\n"
         "          a.out_idx + (size_t)o * a.k_padded + kg)));", ""),
        ("dequant_common.cuh",
         "#pragma unroll 1\n    for (int o = staged; o < k_out; ++o)\n"
         "      f(__ldg(a.out_idx + (size_t)o * a.k_padded + kg + i), o);",
         ""),
        ("dequant_common.cuh",
         "    return o < staged_slots(k_out)\n"
         "               ? oval[o * kChunkK + i]\n"
         "               : __ldg(a.out_val + (size_t)o * a.k_padded + kg + i);",
         "    return oval[o * kChunkK + i];")],
    "no_split_epilogue": [   # every slice writes its tile directly
        ("dequant_common.cuh", "  if (slices > 1) {\n    float* part",
         "  if (false) {\n    float* part"),
        ("dequant_common.cuh", "      if (slices == 1 && ok[q])",
         "      if (ok[q])"),
        ("dequant_common.cuh", "    if (slices > 1) {\n      int s = 0;",
         "    if (false) {\n      int s = 0;")],
    "no_product": [
        ("dequant_common.cuh", '  asm volatile(\n      "mma.sync',
         "  c[0] += __uint_as_float((a.x ^ a.w ^ b.x) & 0x3fffffffu);\n"
         '  if (0) asm volatile(\n      "mma.sync')],
    "no_x_gather": [   # the pre-pass still runs: it zeroes the counters
        ("dequant_kernels.cuh",
         "  if (e0 >= (size_t)a.M * a.k_padded) return;", "  return;")],
    "empty": [
        ("dequant_kernels.cuh",
         "decode_kernel(const Args a) {\n"
         "  extern __shared__ __align__(16) char smem[];",
         "decode_kernel(const Args a) {\n"
         "  extern __shared__ __align__(16) char smem[];\n"
         "  if (a.M > 0) return;"),
        ("dequant_kernels.cuh",
         "prefill_kernel(const Args a) {\n"
         "  extern __shared__ __align__(16) char smem[];",
         "prefill_kernel(const Args a) {\n"
         "  extern __shared__ __align__(16) char smem[];\n"
         "  if (a.M > 0) return;")],
}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]


def nvcc(args):
    r = subprocess.run([cuda_build._nvcc(), *args],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])


def build(name, csrc, reps, out_dir):
    """Copy ``csrc`` with the replacements into out_dir/name and link the
    library from every .cu in it (one nvcc per source)."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    for f in csrc.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (d / f.name).write_text(f.read_text())
    for fname, old, new in reps:
        text = (d / fname).read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in {fname}")
        (d / fname).write_text(text.replace(old, new))
    srcs = sorted(d.glob("*.cu"))
    with ThreadPoolExecutor(len(srcs)) as ex:
        list(ex.map(lambda s: nvcc([*FLAGS, "-c", "-o", str(s) + ".o",
                                    str(s)]), srcs))
    so = d / "k.so"
    nvcc(["-shared", "-o", str(so), *[str(s) + ".o" for s in srcs]])
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, nargs="*", default=[4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_reading: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops, plan

    out_dir = REPO / "build" / "k1_reading"
    csrc = REPO / "src" / "repro_torch" / "csrc"
    variants = {"base": [], **VARIANTS}
    t0 = time.time()
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(
            lambda kv: build(kv[0], csrc, kv[1], out_dir),
            variants.items())))
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).claq_dequant_matmul
        fn.argtypes = [P, I, P, I, I, P, P, I, I, I, P, I, P, P, I, P, P, P,
                       I, I, I, I, I, I, I, I, P, P, P, P]
        fn.restype = I
        fns[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    from torch.profiler import ProfilerActivity, profile
    results = []
    for rows, cols in cs.LLAMA_SHAPES:
        pqt = plan.prepare_for_inference(
            cs.synthetic_qt(rows, cols, gen, host_gen, "cuda"))
        for m in args.m:
            x = torch.randn((m, cols), generator=gen,
                            device="cuda").bfloat16()
            calls = list(ops.group_calls(x, pqt, "kernel"))
            rec = {"card": card, "shape": f"{rows}x{cols}", "m": m,
                   "chunks": [g.k_padded // 64 for g in pqt.groups],
                   "us_per_launch": {}}
            for name, fn in fns.items():
                dm._FN = fn

                def chain():
                    y = None
                    for xg, kw in calls:
                        y = dm.dequant_matmul(xg, acc=y,
                                              compute_dtype=torch.bfloat16,
                                              **kw)
                    return y

                chain()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        flush.zero_()
                        chain()
                    torch.cuda.synchronize()
                per = {}
                for ev in prof.key_averages():
                    key = ev.key
                    if "claq" not in key and "dequant_matmul_kernel" \
                            not in key:
                        continue
                    if "gather_x" in key:
                        tag = "gather_x"
                    elif "dequant_matmul_kernel" in key:
                        tag = "all"
                    else:
                        tag = key.split("kernel<")[1].split(",")[0]
                    per[tag] = ev.device_time_total / 5
                rec["us_per_launch"][name] = per
            print(json.dumps(rec), flush=True)
            results.append(rec)
    dm._FN = None
    (out_dir / "reading.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
