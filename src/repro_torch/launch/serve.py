"""Serving launcher: quantize (optional) + batched engine demo (port of
the quantize-then-serve path of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --bits 2.2 --act-dtype int8 --device cpu

A random-init model (seed 0) is CLAQ-quantized in process when ``--bits``
is given (calibration on 8 synthetic 64-token segments, K-Means with 6
iterations, GPTQ blocks of 32, Adaptive Precision for a fractional
``--bits``) and served greedily through ``ServingEngine``.  ``--device``
defaults to ``cuda`` and raises without a card; pass ``cpu`` to run the
kernels' plain versions.  The reference's other flags (speculation,
paging, meshes, lifecycle, telemetry, control) belong to later slices.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import APConfig, CLAQConfig
from repro_torch.data import calibration_set
from repro_torch.launch.quantize import claq_quantize
from repro_torch.models import api
from repro_torch.serve import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=float, default=0,
                    help="0 = fp; else CLAQ-quantize to this avg bit-width")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=16,
                    help="smallest prefill length bucket")
    ap.add_argument("--no-bucketing", action="store_true",
                    help="admit at exact prompt lengths")
    ap.add_argument("--act-dtype", choices=("f32", "int8"), default="f32",
                    help="activation precision for quantized matmuls: int8 "
                         "= per-token dynamic absmax quantization folded "
                         "into the kernel (changes numerics within the "
                         "bound of kernels/ref.ref_act_int8_bound)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no silent CPU "
                         "fallback)")
    args = ap.parse_args(argv)

    device = dev_lib.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = api.init_params(gen, cfg, device)

    if args.bits > 0:
        base = int(args.bits)
        qcfg = CLAQConfig(
            bits=base, method="kmeans", kmeans_iters=6, gptq_blocksize=32,
            ap=(APConfig(args.bits, base, 4) if args.bits != base else None))
        calib = calibration_set(cfg.vocab, n_segments=8, seq_len=64)
        t0 = time.time()
        model, report = claq_quantize(model, cfg, calib, qcfg)
        print(f"[serve] CLAQ-quantized to "
              f"{report.mean_effective_bits:.2f} "
              f"bits in {time.time() - t0:.1f}s")

    eng = ServingEngine(model, cfg, n_slots=args.slots,
                        max_len=args.max_len, min_bucket=args.min_bucket,
                        bucketing=not args.no_bucketing,
                        act_dtype=args.act_dtype, device=device)
    if args.act_dtype != "f32":
        print(f"[serve] activations: per-token {args.act_dtype} "
              f"(opt-in weight-activation quantized serving)")
    rng = np.random.default_rng(0)
    pending = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(args.requests)]
    t0 = time.time()
    steps = 0
    step_tokens = 0
    t_decode = 0.0
    while pending or eng.active:
        if pending and eng.free:
            n = min(len(pending), len(eng.free))
            eng.add_requests(pending[:n], max_new_tokens=args.max_new)
            del pending[:n]
        ts = time.time()
        emitted = eng.step()
        if emitted:
            steps += 1
            step_tokens += len(emitted)
            t_decode += time.time() - ts
    finished = eng.take_finished()
    dt = time.time() - t0
    total_tokens = sum(len(r.tokens) for r in finished.values())
    st = eng.stats()
    print(f"[serve] {len(finished)} requests, {total_tokens} tokens, "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    if steps and t_decode:
        print(f"[serve] {steps} decode steps, "
              f"{step_tokens / steps:.2f} tokens/step, "
              f"{t_decode / steps * 1e3:.1f} ms/step "
              f"({step_tokens / max(t_decode, 1e-9):.1f} decode tok/s)")
    print(f"[serve] prefill traces {st['prefill_traces']} "
          f"(buckets {st['buckets']}), compile-cache hit rate "
          f"{st['bucket_hit_rate']:.0%}")
    print(f"[serve] lifecycle: {json.dumps(st['lifecycle'])}")
    if eng.active:
        raise SystemExit(
            f"[serve] {len(eng.active)} requests never reached a terminal "
            f"state — lifecycle invariant violated")
    return st


if __name__ == "__main__":
    main()
