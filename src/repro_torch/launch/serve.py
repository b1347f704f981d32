"""Serving launcher: quantize (optional) + batched engine demo (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --bits 2.2 --act-dtype int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --bits 2.2 --spec-gamma 4 --kv-layout paged --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1_7b \
      --smoke --inject-faults --chunk-tokens 16 --slo-ttft-p99-ms 200 \
      --telemetry --stats --device cpu

A random-init model (seed 0) is CLAQ-quantized in process when ``--bits``
is given (calibration on 8 synthetic 64-token segments, K-Means with 6
iterations, GPTQ blocks of 32, Adaptive Precision for a fractional
``--bits``) and served greedily through ``ServingEngine``.
``--spec-gamma`` > 0 also quantizes a ``--draft-bits`` draft: from the
same calibration (``claq_quantize_with_draft``) for a quantized target,
with K-Means + Outlier Reservation 0.1 for an fp one.  ``--kv-layout
paged`` serves from a page pool (``--page-size``, ``--kv-pool-pages``,
``--kv-dtype``).  Requests go through ``submit()`` and the bounded
admission queue (``--queue-depth``, ``--deadline-ms``); the control plane
has ``--chunk-tokens``, ``--slo-ttft-p99-ms`` / ``--controller-mode`` /
``--cost-model``, ``--guards``, ``--on-pressure``, ``--inject-faults`` /
``--fault-seed`` (a seeded fault plan under a virtual clock), and
``--telemetry`` / ``--replay-trace`` / ``--report-json`` /
``--telemetry-trace`` / ``--stats``; ``--verify-contracts`` runs the
contract gate (``repro_torch.analysis``) at engine init and prints its
report line.  ``--device`` defaults to ``cuda``
and raises without a card; pass ``cpu`` to run the kernels' plain
versions.

A (data, model) mesh (``--mesh-shape DPxTP``, or ``--dp`` / ``--tp``)
serves on DP * TP ranks, one process each, under ``torchrun``; every rank
builds the same seeded model, rank 0 alone quantizes it (and the draft),
as the reference's single controller does, and hands the quantized tree
to every rank (``collectives.broadcast_object``) before the engine
places it, so the ranks serve one quantization whatever their thread
counts or hardware; every rank runs the same requests, and only rank 0
prints the report.  ``--backend`` is explicit: ``nccl``
for one card per rank, ``gloo`` on the CPU or for ranks that share one
card:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch \
      llama1_7b --smoke --bits 2.2 --mesh-shape 2x2 --backend gloo \
      --device cpu
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
from repro_torch.dist import collectives as coll
from repro_torch.dist.context import mesh_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.quantize import claq_quantize, claq_quantize_with_draft
from repro_torch.models import api
from repro_torch.serve import (AdmissionController, AdmissionRejected,
                               FaultInjector, Replayer, RetryPolicy,
                               ServingEngine, SLOConfig, SpecConfig,
                               StepClock, StepCostModel, Telemetry,
                               build_report, load_trace, write_perfetto)


def _build_mesh(args):
    """Resolve --mesh-shape / --dp / --tp into (a (data, model) mesh, this
    rank's device, whether the process group was brought up here), or
    (None, the device, False) for single-device serving."""
    if args.mesh_shape:
        try:
            dp, tp = (int(v) for v in args.mesh_shape.lower().split("x"))
        except ValueError as e:
            raise SystemExit(
                f"--mesh-shape must be DPxTP (e.g. 2x4), got "
                f"{args.mesh_shape!r}") from e
    else:
        dp, tp = max(args.dp, 1), max(args.tp, 1)
    if dp * tp <= 1:
        return None, dev_lib.resolve(args.device), False
    import torch.distributed as dist
    created = not dist.is_initialized()
    device = mesh_lib.init_distributed(args.backend, args.device)
    world = dist.get_world_size()
    if world != dp * tp:
        raise SystemExit(
            f"mesh {dp}x{tp} needs {dp * tp} ranks, the world has {world} "
            f"(run under torchrun --nproc-per-node {dp * tp})")
    return (mesh_lib.make_debug_mesh((dp, tp), device_type=device.type),
            device, created)


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
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="bounded admission queue depth (0 = engine "
                         "default, 2x slots); submissions beyond it see "
                         "typed backpressure and wait in the launcher")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request SLO deadline; expired work is "
                         "ABANDONED (queued or running), 0 = none")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill: split admitted prompts' prefill "
                         "into chunks of this many tokens interleaved with "
                         "decode (0 = monolithic; must divide --max-len)")
    ap.add_argument("--slo-ttft-p99-ms", type=float, default=0,
                    help="attach the SLO-guarded admission controller "
                         "defending this p99 TTFT target via the "
                         "degradation ladder (0 = off)")
    ap.add_argument("--controller-mode", choices=("admission", "full"),
                    default="full",
                    help="controller ladder: 'admission' = defer/shed "
                         "only; 'full' adds spec_half/spec_off/kv_int8 "
                         "rungs (capability-gated)")
    ap.add_argument("--cost-model", action="store_true",
                    help="price each step from the work it ran (padded "
                         "prefill tokens, decode/draft calls, verify "
                         "span) — implied by --slo-ttft-p99-ms")
    ap.add_argument("--guards", action="store_true",
                    help="count non-finite logits per row each step; a "
                         "non-finite row quarantines only its own request "
                         "(FAILED + diagnostics)")
    ap.add_argument("--on-pressure", choices=("preempt", "truncate"),
                    default="preempt",
                    help="cache-pressure policy: preempt (evict + resume, "
                         "default) or truncate")
    ap.add_argument("--inject-faults", action="store_true",
                    help="drive the run under a seeded fault plan (NaN/Inf "
                         "logits, pressure windows, transient step "
                         "failures); implies --guards and a virtual clock "
                         "so outcomes replay exactly")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the injected fault plan")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach the per-request span recorder — lifecycle "
                         "events + TTFT/TPOT histograms, host-side only")
    ap.add_argument("--replay-trace", metavar="PATH",
                    help="drive submissions from this JSONL arrival trace "
                         "instead of --requests (implies --telemetry; "
                         "synthesize one with `python -m "
                         "repro_torch.serve.replay`)")
    ap.add_argument("--report-json", metavar="PATH",
                    help="write the end-of-run scheduling report here "
                         "(implies --telemetry)")
    ap.add_argument("--telemetry-trace", metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON here "
                         "(implies --telemetry)")
    ap.add_argument("--stats", action="store_true",
                    help="print the uniform metrics report at exit (every "
                         "stats() counter through the metrics registry)")
    ap.add_argument("--verify-contracts", action="store_true",
                    help="run the hot-path contract checker over one "
                         "profiled decode step at engine init (raises on "
                         "a violated contract)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no silent CPU "
                         "fallback)")
    ap.add_argument("--mesh-shape", default=None,
                    help="DPxTP mesh, e.g. 2x2 (data x model); run under "
                         "torchrun with DP * TP processes")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel mesh size (alternative to "
                         "--mesh-shape)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor(model)-parallel mesh size")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="nccl",
                    help="process-group backend of a mesh: nccl (one card "
                         "per rank) or gloo (the CPU, or ranks sharing "
                         "one card)")
    args = ap.parse_args(argv)

    mesh, device, own_group = _build_mesh(args)
    rank0 = mesh is None or mesh.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if not rank0:
        args.report_json = args.telemetry_trace = None
    if mesh is not None:
        say(f"[serve] mesh {mesh_shape(mesh)} over {mesh.size()} "
            f"ranks ({args.backend})")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = api.init_params(gen, cfg, device)

    spec = (SpecConfig(gamma=args.spec_gamma, draft_bits=args.draft_bits)
            if args.spec_gamma > 0 else None)
    draft = None
    # rank 0 quantizes; the other ranks receive its tree below
    quantize_here = mesh is None or mesh.get_rank() == 0
    if args.bits > 0 and quantize_here:
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
            say(f"[serve] CLAQ-quantized target to "
                  f"{report.mean_effective_bits:.2f} bits + draft to "
                  f"{drep.mean_effective_bits:.2f} bits in "
                  f"{time.time() - t0:.1f}s (one calibration pass)")
        else:
            model, report = claq_quantize(model, cfg, calib, qcfg)
            say(f"[serve] CLAQ-quantized to "
                  f"{report.mean_effective_bits:.2f} "
                  f"bits in {time.time() - t0:.1f}s")
    elif spec is not None and quantize_here:
        # fp target: the draft is a CLAQ quantization of the same weights
        # (a second copy, quantized in place), Outlier Reservation kept
        calib = calibration_set(cfg.vocab, n_segments=8, seq_len=64)
        dcfg = CLAQConfig(bits=args.draft_bits, method="kmeans",
                          kmeans_iters=6, gptq_blocksize=32,
                          orr=ORConfig(0.1))
        draft, drep = claq_quantize(copy.deepcopy(model), cfg, calib, dcfg)
        say(f"[serve] fp target + {drep.mean_effective_bits:.2f}-bit "
              f"CLAQ draft")
    if mesh is not None and (args.bits > 0 or spec is not None):
        model, draft = coll.broadcast_object((model, draft), device)

    injector = None
    clock = None
    if args.inject_faults:
        # faults imply guards (NaN injection must quarantine, not poison)
        # and a virtual clock (deadline outcomes must replay exactly)
        injector = FaultInjector(seed=args.fault_seed)
        clock = StepClock()
        say(f"[serve] fault plan (seed {args.fault_seed}): "
              f"{json.dumps(injector.describe())}")
    telemetry = (Telemetry()
                 if (args.telemetry or args.replay_trace or args.report_json
                     or args.telemetry_trace) else None)
    controller = None
    if args.slo_ttft_p99_ms > 0:
        controller = AdmissionController(
            SLOConfig(ttft_p99_ms=args.slo_ttft_p99_ms),
            mode=args.controller_mode)
    cost_model = (StepCostModel()
                  if args.cost_model or controller is not None else None)
    paged = args.kv_layout == "paged"
    eng = ServingEngine(model, cfg, n_slots=args.slots,
                        max_len=args.max_len, min_bucket=args.min_bucket,
                        bucketing=not args.no_bucketing,
                        draft_params=draft, spec=spec,
                        draft_plan_bn=args.draft_plan_bn or None,
                        draft_plan_bk=args.draft_plan_bk or None,
                        act_dtype=args.act_dtype,
                        guards=args.guards or args.inject_faults,
                        faults=injector,
                        queue_depth=args.queue_depth or None,
                        on_pressure=args.on_pressure, clock=clock,
                        kv_layout=args.kv_layout,
                        page_size=args.page_size if paged else None,
                        kv_pages=(args.kv_pool_pages or None) if paged
                        else None,
                        kv_dtype=(args.kv_dtype if paged
                                  and args.kv_dtype != "f32" else None),
                        telemetry=telemetry,
                        chunked_prefill=args.chunk_tokens or None,
                        controller=controller, cost_model=cost_model,
                        mesh=mesh,
                        verify_contracts=args.verify_contracts,
                        device=device)
    if controller is not None:
        say(f"[serve] SLO controller: p99 TTFT target "
              f"{args.slo_ttft_p99_ms:.0f}ms, ladder "
              f"{'->'.join(controller.ladder)}")
    if args.chunk_tokens:
        say(f"[serve] chunked prefill: {args.chunk_tokens}-token chunks "
              f"interleaved with decode")
    if args.verify_contracts:
        rep = eng.contract_report
        say(f"[serve] contracts: {len(rep.rules_run)} rules clean "
              f"({len(rep.findings)} warning(s)) over the profiled "
              f"decode step")
    if paged:
        say(f"[serve] paged KV cache: page_size={eng.page_size}, "
              f"pool={eng.n_pages} pages, resident dtype "
              f"{eng.kv_dtype or 'fp'}")
    if args.act_dtype != "f32":
        say(f"[serve] activations: per-token {args.act_dtype} "
              f"(opt-in weight-activation quantized serving)")
    rng = np.random.default_rng(0)
    pending = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).tolist()
               for _ in range(args.requests)]
    # bounded retry absorbs the injected transient step failures; under
    # the virtual clock the backoff never sleeps
    retry = RetryPolicy(max_attempts=4,
                        backoff_s=0.0 if injector is not None else 0.05)
    t0 = time.time()
    steps = 0
    step_tokens = 0
    t_decode = 0.0
    backpressure_waits = 0
    fault_retries = 0
    report = None
    if args.replay_trace:
        # trace-driven mode: the Replayer owns arrivals, stepping and the
        # end-of-run report; --requests is ignored
        trace = load_trace(args.replay_trace)
        say(f"[serve] replaying {len(trace)} arrivals from "
              f"{args.replay_trace}")
        report = Replayer(eng, trace, retry=retry).run()
        steps = report["driver_steps"]
        backpressure_waits = report["scheduling"]["backpressure_waits"]
        fault_retries = report["scheduling"]["transient_retries"]
    else:
        while pending or eng.active or len(eng.queue) or eng.pending_prefills:
            while pending:
                try:
                    eng.submit(pending[0], max_new_tokens=args.max_new,
                               deadline_ms=args.deadline_ms or None)
                    pending.pop(0)
                except AdmissionRejected:
                    if not eng.active and not len(eng.queue):
                        raise    # empty engine rejected it: will never fit
                    backpressure_waits += 1  # queue full: drain first
                    break
            ts = time.time()
            emitted, retries = retry.run(eng.step)
            fault_retries += retries
            if clock is not None:
                clock.advance()
            if emitted:
                steps += 1
                step_tokens += sum(len(v) if isinstance(v, list) else 1
                                   for v in emitted.values())
                t_decode += time.time() - ts
    finished = eng.take_finished()
    dt = time.time() - t0
    total_tokens = sum(r.tokens_out for r in finished.values())
    st = eng.stats()
    say(f"[serve] {len(finished)} requests, {total_tokens} tokens, "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    if steps and t_decode:
        say(f"[serve] {steps} decode steps, "
              f"{step_tokens / steps:.2f} tokens/step, "
              f"{t_decode / steps * 1e3:.1f} ms/step "
              f"({step_tokens / max(t_decode, 1e-9):.1f} decode tok/s)")
    say(f"[serve] prefill traces {st['prefill_traces']} "
          f"(buckets {st['buckets']}), compile-cache hit rate "
          f"{st['bucket_hit_rate']:.0%}")
    if spec is not None:
        say(f"[serve] speculation gamma={spec.gamma}: acceptance "
              f"{st['acceptance_rate']:.1%} ({st['spec_accepted']}/"
              f"{st['spec_drafted']} draft tokens), "
              f"{st['tokens_per_step']:.2f} tokens per window over all "
              f"slots")
    if paged:
        pg = st["paged"]
        say(f"[serve] pages: peak {pg['peak_pages_in_use']}/"
              f"{pg['n_pages']}, prefix hits {pg['prefix_hits']}, "
              f"copy-on-write {pg['cow_copies']}, "
              f"{pg['bytes_per_page']} bytes a page")
    nonterminal = len(eng.active) + st["queued"] + eng.pending_prefills
    say(f"[serve] lifecycle: {json.dumps(st['lifecycle'])}, preemptions "
          f"{st['preemptions']}, resumes {st['resumes']}, backpressure "
          f"waits {backpressure_waits}, transient-fault retries "
          f"{fault_retries}")
    if telemetry is not None and report is None:
        # non-replay run with telemetry on: the report the Replayer would
        # have produced
        report = build_report(
            eng, elapsed=dt, driver_steps=steps,
            extra={"backpressure_waits": backpressure_waits,
                   "transient_retries": fault_retries,
                   "expired_at_submit": 0, "rejected_unfittable": 0})
    if report is not None:
        tt, tp = report["ttft_ms"], report["tpot_ms"]
        say(f"[serve] ttft_ms p50/p90/p99 = {tt['p50']:.2f}/"
              f"{tt['p90']:.2f}/{tt['p99']:.2f}  tpot_ms p50/p90/p99 = "
              f"{tp['p50']:.2f}/{tp['p90']:.2f}/{tp['p99']:.2f}  "
              f"tokens/s/slot = {report['tokens']['per_s_per_slot']:.2f}")
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        say(f"[serve] scheduling report -> {args.report_json}")
    if args.telemetry_trace:
        write_perfetto(args.telemetry_trace, telemetry)
        say(f"[serve] perfetto trace -> {args.telemetry_trace} "
              f"(open at ui.perfetto.dev)")
    if args.stats:
        say(eng.metrics().render(title="serve metrics"))
    if nonterminal:
        raise SystemExit(
            f"[serve] {nonterminal} requests never reached a terminal "
            f"state — lifecycle invariant violated")
    if args.inject_faults:
        say("[serve] fault plan survived: every request terminal")
    if own_group:
        import torch.distributed as dist
        dist.destroy_process_group()
    return dict(st, tokens=[finished[u].tokens for u in sorted(finished)])


if __name__ == "__main__":
    main()
