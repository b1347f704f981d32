"""Serving launcher: quantize (optional) + batched engine demo (port of
the quantize-then-serve, speculation and paging paths of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --bits 2.2 --act-dtype int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --bits 2.2 --spec-gamma 4 --kv-layout paged --device cpu

A random-init model (seed 0) is CLAQ-quantized in process when ``--bits``
is given (calibration on 8 synthetic 64-token segments, K-Means with 6
iterations, GPTQ blocks of 32, Adaptive Precision for a fractional
``--bits``) and served greedily through ``ServingEngine``.
``--spec-gamma`` > 0 also quantizes a ``--draft-bits`` draft: from the
same calibration (``claq_quantize_with_draft``) for a quantized target,
with K-Means + Outlier Reservation 0.1 for an fp one.  ``--kv-layout
paged`` serves from a page pool (``--page-size``, ``--kv-pool-pages``,
``--kv-dtype``).  ``--device`` defaults to ``cuda`` and raises without a
card; pass ``cpu`` to run the kernels' plain versions.  The reference's
other flags (meshes, lifecycle, telemetry, control) belong to later
slices.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import APConfig, CLAQConfig, ORConfig
from repro_torch.data import calibration_set
from repro_torch.launch.quantize import claq_quantize, claq_quantize_with_draft
from repro_torch.models import api
from repro_torch.serve import ServingEngine, SpecConfig


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
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="speculation window length; 0 = vanilla decode. "
                         ">0 quantizes a low-bit draft of the same "
                         "checkpoint from the same calibration pass and "
                         "serves with propose/verify/rollback windows "
                         "(lossless for greedy decoding)")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="code bit-width of the speculative draft model")
    ap.add_argument("--draft-plan-bn", type=int, default=0,
                    help="plan N-tile cap for the DRAFT's prepared plans "
                         "(0 = inherit the target's)")
    ap.add_argument("--draft-plan-bk", type=int, default=0,
                    help="plan K-block cap for the draft's prepared plans "
                         "(0 = inherit)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="slot KV cache layout: contiguous (one "
                         "(max_len,) strip per slot) or paged (a page pool "
                         "+ per-slot page tables; pages allocated on "
                         "demand, freed at retirement, shared across "
                         "common prompt prefixes)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged layout; must divide "
                         "--max-len)")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="page-pool size (paged layout; 0 = capacity-"
                         "equivalent to contiguous: slots * max_len / "
                         "page_size)")
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default="f32",
                    help="resident-page precision (paged layout): int8 "
                         "stores K/V quantized per token row with absmax "
                         "scales (bounded error)")
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

    spec = (SpecConfig(gamma=args.spec_gamma, draft_bits=args.draft_bits)
            if args.spec_gamma > 0 else None)
    draft = None
    if args.bits > 0:
        base = int(args.bits)
        qcfg = CLAQConfig(
            bits=base, method="kmeans", kmeans_iters=6, gptq_blocksize=32,
            ap=(APConfig(args.bits, base, 4) if args.bits != base else None))
        calib = calibration_set(cfg.vocab, n_segments=8, seq_len=64)
        t0 = time.time()
        if spec is not None:
            # one calibration pass, two quantizations: the serving target
            # and the low-bit speculative draft share the tapped Hessians
            (model, report), (draft, drep) = claq_quantize_with_draft(
                model, cfg, calib, qcfg, draft_bits=spec.draft_bits)
            print(f"[serve] CLAQ-quantized target to "
                  f"{report.mean_effective_bits:.2f} bits + draft to "
                  f"{drep.mean_effective_bits:.2f} bits in "
                  f"{time.time() - t0:.1f}s (one calibration pass)")
        else:
            model, report = claq_quantize(model, cfg, calib, qcfg)
            print(f"[serve] CLAQ-quantized to "
                  f"{report.mean_effective_bits:.2f} "
                  f"bits in {time.time() - t0:.1f}s")
    elif spec is not None:
        # fp target: the draft is a CLAQ quantization of the same weights
        # (a second copy, quantized in place), Outlier Reservation kept
        calib = calibration_set(cfg.vocab, n_segments=8, seq_len=64)
        dcfg = CLAQConfig(bits=args.draft_bits, method="kmeans",
                          kmeans_iters=6, gptq_blocksize=32,
                          orr=ORConfig(0.1))
        draft, drep = claq_quantize(copy.deepcopy(model), cfg, calib, dcfg)
        print(f"[serve] fp target + {drep.mean_effective_bits:.2f}-bit "
              f"CLAQ draft")

    paged = args.kv_layout == "paged"
    eng = ServingEngine(model, cfg, n_slots=args.slots,
                        max_len=args.max_len, min_bucket=args.min_bucket,
                        bucketing=not args.no_bucketing,
                        draft_params=draft, spec=spec,
                        draft_plan_bn=args.draft_plan_bn or None,
                        draft_plan_bk=args.draft_plan_bk or None,
                        act_dtype=args.act_dtype, kv_layout=args.kv_layout,
                        page_size=args.page_size if paged else None,
                        kv_pages=(args.kv_pool_pages or None) if paged
                        else None,
                        kv_dtype=(args.kv_dtype if paged
                                  and args.kv_dtype != "f32" else None),
                        device=device)
    if paged:
        print(f"[serve] paged KV cache: page_size={eng.page_size}, "
              f"pool={eng.n_pages} pages, resident dtype "
              f"{eng.kv_dtype or 'fp'}")
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
            step_tokens += sum(len(v) if isinstance(v, list) else 1
                               for v in emitted.values())
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
    if spec is not None:
        print(f"[serve] speculation gamma={spec.gamma}: acceptance "
              f"{st['acceptance_rate']:.1%} ({st['spec_accepted']}/"
              f"{st['spec_drafted']} draft tokens), "
              f"{st['tokens_per_step']:.2f} tokens per window over all "
              f"slots")
    if paged:
        pg = st["paged"]
        print(f"[serve] pages: peak {pg['peak_pages_in_use']}/"
              f"{pg['n_pages']}, prefix hits {pg['prefix_hits']}, "
              f"copy-on-write {pg['cow_copies']}, "
              f"{pg['bytes_per_page']} bytes a page")
    print(f"[serve] lifecycle: {json.dumps(st['lifecycle'])}")
    if eng.active:
        raise SystemExit(
            f"[serve] {len(eng.active)} requests never reached a terminal "
            f"state — lifecycle invariant violated")
    return st


if __name__ == "__main__":
    main()
