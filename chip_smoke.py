#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA
H100 and hold its CUDA kernel against its plain version.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: K1 (``csrc/dequant_matmul.cu`` and its per-bit-width sources,
     one nvcc each, in parallel) from the checkout's sources;
  3. reference check on a small input: the same synthetic CLAQ model
     served on the card (kernel) and on the CPU (plain version), for the
     smoke llama1_7b, qwen3_moe_30b_a3b (moe), deepseek_v2_236b (moe +
     MLA) and a dense use_mla model; on the last, chunked prefill
     (exactly the monolithic tokens) and speculation with a synthetic
     2-bit draft (vanilla's tokens except after a near tie);
  4. serve llama1_7b at full width (d 4096, bf16; cut to ``SERVE_DEPTH``
     = 16 of its 32 layers to keep the script's time) with
     synthetic CLAQ AP+OR weights through ``ServingEngine``: 8 requests,
     4 slots, 16 new tokens each, with the kernel's launch counts and a
     ``torch.profiler`` reading of two decode steps (device-busy share,
     top kernels by device time);
  4b. speculative serve: the phase-4 target with a synthetic flat 2-bit
     + OR draft of the same shapes (its own seed), gamma 4: tokens held
     to phase 4's under the near-tie rule (at a divergence, vanilla's own
     decode logits there must have a top-2 gap, and a deficit of the
     speculative token to their maximum, below twice the largest
     |verify - successive decode| logit difference over every window,
     measured in an untimed second serve of the same windows, whose
     tokens must equal the timed one's), windows, acceptance, ms per
     emitted token,
     K1 launches aligned (draft) and gathered (target), the device-busy
     share over two windows; then the target as its own draft (windows
     accept, emit several tokens and roll back by k > 0), same rule;
  4c. paged serve (16-token pages): a capacity-equivalent fp pool
     (tokens exactly phase 4's), an int8 pool (budgets, bytes a page
     under 1/3 of an f32 page's, tokens counted), prompts sharing a 32-token
     prefix (prefix hits, fewer pages than without sharing, tokens
     exactly the contiguous engine's) and speculation on the fp pool with
     either draft (near-tie rule against phase 4, exactly phase 4b's
     tokens);
  5. kernel vs plain version on the card at every (M, N, K) the serve
     phase gave K1: M = n_slots for decode and Bb * bucket for each
     prefill shape it ran, at the three matrix shapes of llama1_7b, on
     the served model's own plans (a 2/3/4-bit gathered chain through
     ``acc``, with outliers; also pre-gathered as "blocked") and on a
     single-width plan ("aligned"), f32 and bf16; times beside the bound
     and a ``torch.matmul`` yardstick on the pre-dequantized weight: eager
     (``ms``, host enqueue included), device time from a CUDA graph of the
     chain (``device_ms``) and the wrapper's host time per call; then
     the same at the M values only phases 4b and 4c gave K1 (the
     verify's n_slots * (gamma+1), new prefill shapes; the "aligned"
     cases at M = n_slots are the draft's plan);
  6. the phase-4 model served again with int8 activations
     (``ServingEngine(act_dtype="int8")``, K1e), same prompts, with the
     int8 launch counts;
  7. K1e (int8 x, the (M, 1) scale on the last launch) vs its plain
     version at every M phase 6 gave it, as in phase 5, and within
     ``ref_act_int8_bound`` of the f32-activation kernel (after phase 8,
     the same at the M values only its speculation gave K1e: the
     verify's n_slots * (gamma+1), new prefill shapes);
  11. qwen3_moe_30b_a3b at full width (d 2048, 32 heads, 128 experts
     top-8, d_ff_expert 768, vocab 151936, bf16), cut to ``MOE_DEPTH``
     layers, synthetic CLAQ AP+OR weights on every matmul and expert
     stack, phase 4's prompts through ``ServingEngine`` (4 slots): batch-1
     unpadded prefills only, launch counts, the (shape, M) pairs K1 ran,
     capacity drops, a profile of two decode steps, the experts'
     dequantize against their einsums (CUDA events), peak memory, and an
     untimed second serve with equal tokens;
  11b. deepseek_v2_236b at full width (d 5120, 128 heads, MLA q_lora
     1536 / kv_lora 512 / rope 64, 160 experts top-6 + 2 shared), 1 layer,
     served contiguous, paged fp (exactly the contiguous tokens) and paged
     int8 (budgets, bytes a page), the same readings; chunked prefill
     refused (moe); latent cache bytes a token against a full K/V's.
     Then K1 and K1e against their plain versions at each of the 10 new
     (out, in) shapes and every M 11/11b gave it (device ms beside
     ``torch.matmul`` and the bound).  Phases 11-11b run in a process of
     their own, started after phase 10 beside the mesh phases (their
     ranks leave the host's other cores and most of the card idle) and
     ended before phase 16 starts, so their times and those of
     phases 14-15 are shared-card readings;
  12. rwkv6_7b at full width (d 4096, 64 heads of 64, d_ff 14336, vocab
     65536, bf16), ``RWKV_DEPTH`` of its 32 layers, synthetic AP+OR
     weights, phase 4's prompts through ``ServingEngine`` (4 slots,
     unpadded prefills), then at batch 1 (tokens held to the batched ones
     under the near-tie rule, its limit twice the largest |batched -
     batch-1| decode logit gap) and with one priority preemption and
     resume (held the same way); then, in f32 activations, the chunked
     prefill of a 100-token prompt against 100 recurrent decode steps
     (last logits within 1e-3 of their scale);
  12b. zamba2_1p2b at full width and depth (38 Mamba2 layers, 7 shared
     attention sites, d 2048, state 64, window 4096): (a) as phase 12;
     (b) one 4200-token prompt at ``max_len`` 4608 (the prefill rolls the
     4096-row ring caches, 64 decode steps wrap them), in f32
     activations, its decode logits against a cacheless windowed forward
     (1e-3 of their scale; greedy tokens under the near-tie rule);
  12c. seamless_m4t_medium at full width and depth (12 + 12 layers, d
     1024, vocab 256224) through ``models.api`` (the engine refuses
     encdec): prefill over seeded 4 x 200 frames and 16 decode steps,
     launch counts; then in f32 activations the decode logits against a
     teacher-forced ``decode_blocks`` forward.  K1 and K1e are then held
     to their plain versions at the 11 (out, in) shapes of 12-12c and
     every M they gave K1.  Phases 12-12c run in a process of their own
     beside the mesh phases, as 11-11b do, and end before phase 16's
     ranks start (two (2, 1) ranks of 16c's training hold ~31.5 GB each;
     a side phase beside them ran the card out of memory);
  10. train, then checkpoint (run after phase 13, before phase 14):
     llama1_7b at full width (cut in depth to ``QUANT_DEPTH``), bf16 params and f32 AdamW moments, 20 steps of
     ``train.make_train_step`` on ``data.SyntheticCorpus`` (B 4, S 512,
     warmup 5, cosine; one step in 2 microbatches) under deterministic
     algorithms: the loss falls; the state is saved asynchronously after
     step 10 while the next steps run, restored into a fresh model and
     optimizer state (bitwise the saved state) and trained on to step 20,
     each loss equal to the straight run's; ms per step, tokens/s, peak
     memory, a profile of two steps, checkpoint bytes and seconds;
  8. quantize, then serve: phase 10's trained model calibrated on
     synthetic tokens and CLAQ-quantized on the card, target and 2-bit
     draft from one calibration
     (``launch.quantize.claq_quantize_with_draft``, the recipe of
     ``launch.serve --bits 2.2 --spec-gamma``), one 4096x4096 matrix also
     quantized on the CPU (in a process of its own on
     ``CPU_CHECK_THREADS`` threads, started after phase 10 and run beside
     the mesh phases) and held against the card's (with a full-rank
     Hessian); perplexity on 2 eval
     batches (B 4, S 512) of fp, RTN uniform 2-bit, the draft and the
     target (the last two through K1 blocked at M = 2048, launches
     counted); then the target served with int8 activations, vanilla and
     speculatively (acceptance rate; near-tie rule as in 4b); K1 is
     then held to its plain version at M = 2048
     as in phase 5;
  10b. the trained substrate of ``benchmarks/common.trained_model`` (vocab
     512, 4 layers, d_model 160, f32, 200 steps) trained on the card; the
     paper's orderings of ``tests/test_pipeline_e2e.py`` on its
     perplexities; the AP+OR target served with its 2-bit draft at gamma
     4 (acceptance, near-tie divergences), every plan it served held to
     the plain K1; in a process of its own beside the mesh phases, as
     11-11b and 12-12c are, ended before phase 16's ranks start;
  9. the serving control plane on phase 4's model (run after 4c, before
     phase 5): (a) phase 4's prompts through ``submit()`` under a
     StepClock and a seeded pressure-only fault plan — at least 2
     requests preempted and resumed (batch-1 prefill, M = 1 decode
     replay), all FINISHED, tokens held to phase 4's under the near-tie
     rule (a first-token divergence is judged on the prompt's batch-1
     prefill row), ms per resume; (b) ``guards=True`` with a plan
     injecting NaN and Inf into a row each and one transient step failure,
     under ``run_to_completion(retry=...)``: exactly the injected requests
     FAILED, the rest phase 4's tokens (near-tie rule), decode ms per step
     with guards beside phase 4's; (c) four prompts of 150-240 tokens in
     64-token chunks under a 64-token budget, interleaved with decode,
     against the monolithic run of the same schedule (near-tie rule,
     prefill ms of both); (d) a seeded storm replayed on a speculative
     (4b's draft, gamma 4), chunked, paged engine with the full SLO
     controller, a StepCostModel and a StepClock — the ladder reaches
     spec_off, the report validates, two replays give byte-identical
     reports, the Perfetto export is well formed; (e) the same trace under
     the wall clock, no controller: TTFT, TPOT and queue-wait percentiles.
     Phase 5's and 7b's new-M passes then also hold K1 and K1e at the M
     values only phase 9 gave K1 (1, the resume buckets, Bb * 64, 12 for
     spec_half's verify; bf16, aligned and gathered plans).
  13. the contract gate (``ServingEngine(verify_contracts=True)``, run
     after phase 6 on phase 4's model, contiguous and on int8 pages, and
     at the end of phases 11, 12 and 12b on their engines): each report
     clean (an ERROR finding raises and ends the run), its rules, findings
     and the transfers of the profiled decode step logged — exactly one
     ``Memcpy DtoH`` (``_sample``'s) asserted; then a violating trace
     (a second DtoH) must keep an engine from coming up.
  14. distribution (``ServingEngine(mesh=...)``, run after phase 13):
     (a) a (1, 1) mesh on nccl (world size 1, in this process) over phase
     4's model and prompts: tokens exactly phase 4's, ``stats()["mesh"]``
     {"data": 1, "model": 1}; (b) two spawned ranks sharing the card over
     gloo (NCCL refuses two ranks on one device), meshes (1, 2) and
     (2, 1), serve llama1_7b at full width and ``MESH_DEPTH`` = 1 layer
     (synthetic AP+OR weights from phase 4's seed) on phase 4's prompts:
     tokens held to a single-rank engine's under the near-tie rule (the
     limit twice each rank's largest |sharded - single-device| logit
     gap on the single-rank tokens, teacher-forced, and at least two bf16
     steps at the diverging row's largest logit: a data rank decodes 2
     rows where the single rank decodes 4, and the card's GEMMs need not
     sum a row alike at both; K1's K split follows N), each rank's plane
     bytes, K1 launches and all-gathers (count, bytes) a decode step,
     decode ms a step, and the contract gate's HLO-AG1 / HLO-CB1 with no
     finding; (c) K1 and K1e against their plain versions at every
     shard-local shape of llama1_7b's plans for tp = 2, 4 and 8 (where
     the tiles divide), first and last block, and the largest gap of the
     blocks' outputs to the whole launch's columns; (d) the same two
     ranks quantize a 512 x 512 matrix row-sharded, held to the
     single-rank result (Q to rtol 1e-4 / atol 1e-5, the proxy loss to
     1e-3); (e) the same two ranks as two pods of a (pod 2, data 1,
     model 1) mesh (slots over "dp" = pod x data, the sampled tokens
     gathered over both) emit (b)'s (2, 1) tokens bit for bit; (f) the
     same ranks serve (b)'s model from a page pool split over "dp"
     (``SPLIT_POOL_PAGES`` + 1 = 64 page rows, 32 a rank, 16-token pages,
     ``max_len`` 256, 4 slots), bf16 and int8 pages, on (2, 1) and on the
     two pods: every rank holds half the whole pool's bytes; a prefill of
     Bb rows runs Bb/2 on a rank where 2 divides Bb; at one decode step
     each rank's view of its slots' pages (its block and the exchange)
     equals a whole-pool replica's (the blocks gathered over "dp") bit
     for bit; tokens held to a single-rank paged engine's under (b)'s
     rule, the pods' bit for bit the (2, 1) run's; phase 4c's shared
     prefix served after phase 4's prompts, a copy-on-write crossing the
     ranks; the gate at construction with no finding the contiguous
     (2, 1) engine's lacks, one transfer to the host a step, the
     exchange's calls and bytes a step from an op trace, prefill ms an
     admission and decode ms a step beside the single rank's, with the
     card's name and power limit; K1 and K1e are then held to their
     plain versions at the M values only these split prefills gave them
     (after phase 7).
  15. training on a mesh and the dry run (run after phase 14): (a) two
     spawned ranks sharing the card over gloo train llama1_7b at full
     width, ``QUANT_DEPTH`` = 1 layer (bf16 params, f32 moments, phase
     10's schedule), B 4 x S 512, ``MESH_TRAIN_STEPS`` = 3 steps on
     ``SyntheticCorpus`` on meshes (1, 2) and (2, 1), against a single-rank
     run of the same seed: the step-0 loss (forward only) within 1e-3,
     every later loss within one bf16 step at its value, the whole params
     after the last step (blocks all-gathered) departing from the single
     rank's (the L2 norm of the gap over that of the single rank's own
     distance from the init) at most twice as far as the single rank's
     two-microbatch twin does (bf16 rounding in another summation order);
     ms a step, peak memory a rank, a step's
     all-gathers and all-reduces (count, bytes) from its op trace, and
     K1's launches (0: fp training); (b) the dry run
     (``launch.dryrun.trace_cell`` on a stand-in mesh, meta tensors) of
     14b's decode (1 layer, 4 slots, ``max_len`` 256, CLAQ stand-in
     plans) and of 15a's train steps: its collectives must equal the
     measured ones exactly; then ``run_cell``'s roofline for llama1_7b
     decode_32k and train_4k on the single production mesh (a model of
     256 cards on the data sheet's figures, not a measurement).
  16. the moe family and MLA with experts on a mesh (run after phase
     15): two spawned ranks sharing the card over gloo, meshes (1, 2) and
     (2, 1): (a) qwen3_moe_30b_a3b at full width, ``MOE_MESH_DEPTH`` = 1
     layer, synthetic AP+OR weights and expert stacks from the seed,
     phase 4's prompts, 4 slots (a data rank's decode gathers the MoE
     rows over "data" and routes the global batch; a placed expert stack
     dequantizes its own rows): a forced replay on each rank (the
     single rank's tokens and router choices, recorded on its own
     replay) holds every row to the single rank's: capacity drops of
     every MoE call exactly, the logit noise within
     ``REPLAY_NOISE_STEPS`` bf16 steps at the row's largest logit, the
     router's within ``REPLAY_ROUTER_NOISE``, at most ``REPLAY_FLIPS``
     argmax flips (ceilings from sound runs); the served tokens equal the
     single rank's except at a first divergence that is a logit near tie
     (14b's rule at twice the replay's noise) or comes at or after a
     router choice the replay found differing (a near tie of the
     router: until then the served run is the replay), the later ones
     counted; per rank plane bytes, K1 launches, a
     decode step's collectives (count, bytes), capacity drops and the
     experts' dequantize device ms a layer beside the single rank's,
     decode ms a step, and the contract gate's HLO-AG1 / HLO-CB1 with no
     finding; (b) deepseek_v2_236b at full width, 1 layer (MLA on the
     rank's heads of ``kv_up``), contiguous cache, the same, plus the
     latent cache bytes a rank, and on (2, 1) from a latent page pool
     split over "dp" (64 page rows, 32 a rank): exactly the contiguous
     (2, 1) run's tokens; (c) training: qwen3_moe_30b_a3b at full
     width, 1 layer, bf16 params, f32 moments, B 4 x S 512,
     ``MOE_TRAIN_STEPS`` = 3 steps against a single-rank run of the seed
     under 15a's loss and param rules (its two-microbatch twin the
     yardstick); ms a step, peak memory and the collectives of a step
     per rank; (d) the dry run's collectives of (a)'s decode on (1, 2)
     (CLAQ stand-in plans) and of (c)'s steps equal the measured ones,
     by kind, count and bytes; then ``run_cell``'s roofline for
     deepseek_v2_236b decode_32k and qwen3_moe_30b_a3b train_4k on the
     single production mesh (a model of 256 cards, not a measurement).
     The phase's time is printed.
  17. rwkv and the hybrid on a mesh (run after phase 16): two spawned
     ranks sharing the card over gloo, meshes (1, 2) and (2, 1): (a)
     rwkv6_7b at full width, ``RWKV_MESH_DEPTH`` = 2 layers, and (b)
     zamba2_1p2b at full width, ``ZAMBA_MESH_DEPTH`` = 7 layers (sites
     before layers 0 and 6, two ring caches with KV heads over "model"),
     synthetic AP+OR weights from the seed, phase 4's prompts, 4 slots:
     each request's served tokens equal the single rank's up to its first
     divergence, which must be a near tie within twice
     ``RECURRENT_REPLAY_NOISE_STEPS`` bf16 steps at the row's largest
     logit and an argmax flip of the forced replay at the same position
     (past it the recurrent state carries the other token); a forced
     replay of the single rank's tokens on each rank holds every prefill
     and decode row within ``RECURRENT_REPLAY_NOISE_STEPS`` bf16 steps of
     the single rank's and at most ``RECURRENT_REPLAY_FLIPS`` argmax
     flips (per family, ceilings from sound runs); per rank the plane
     bytes (half of every plan whose tiles split on (1, 2)), the recurrent
     state and ring bytes (half on (2, 1)), K1 launches, decode ms a step,
     peak memory, a decode step's collectives (count, bytes) equal to the
     dry run's (plus the engine's one all-gather of the sampled tokens on
     a data axis), and the gate's HLO-AG1 / HLO-CB1 with no finding; K1
     against its plain version on both blocks of every shard-local plan
     the ranks ran, at every M they gave it; (c) rwkv6_7b at full width,
     1 layer, trained ``RECURRENT_TRAIN_STEPS`` = 3 steps on each mesh
     under 15a's rules, its steps' collectives equal to the dry run's;
     then ``run_cell``'s roofline for rwkv6_7b and zamba2_1p2b decode_32k
     (sites and Mamba2 layers counted apart) on the single production
     mesh.  The phase's time is printed.
  18. encdec on a mesh (run after phase 17): two spawned ranks sharing
     the card over gloo, meshes (1, 2) and (2, 1): (a) seamless_m4t_medium
     at full width and ``ENCDEC_MESH_DEPTH`` = all 12 + 12 layers,
     synthetic AP+OR weights from the seed prepared into plans, phase
     12c's inputs (4 x 200 seeded frames, 8-token prompts) through
     ``models.api``: prefill and ``MAX_NEW`` decode steps over a placed
     cache (the cross-attention banks' KV heads over "model", their rows
     over "data"; each data rank on its rows); each request's tokens
     equal the single rank's up to a first divergence that is a near tie
     within twice ``ENCDEC_REPLAY_NOISE_STEPS`` bf16 steps and an argmax
     flip of a replay forced to the single rank's tokens, whose every row
     stays within ``ENCDEC_REPLAY_NOISE_STEPS`` bf16 steps of the single
     rank's with at most ``ENCDEC_REPLAY_FLIPS`` flips (fixed ceilings
     from sound runs); per rank the cross-bank bytes (half the single
     rank's on both meshes), the plane bytes, K1 launches, a decode
     step's collectives (count, bytes) equal to the dry run's, decode ms
     a step (median, min) and peak memory; K1 and K1e against their plain
     versions on both blocks of every shard-local plan the ranks ran, at
     every M they gave K1; (b) seamless_m4t_medium at full width, 1
     encoder + 1 decoder layer, B 4 x S ``ENCDEC_TRAIN_S`` (frames and
     tokens), ``ENCDEC_TRAIN_STEPS`` = 3 steps on each mesh under 15a's
     rules, its steps' collectives equal to the dry run's; (c)
     ``run_cell`` of its train_4k, prefill_32k and decode_32k cells on
     the single and the multi-pod production mesh, each "ok", and
     long_500k "skipped" (a model, not a measurement; traced on meta in a
     CPU process started after phase 6).  The phase's time is printed.
It prints a JSON line of kernel records, then, as its last line,
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import multiprocessing
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL, RTOL = 1e-3, 1e-4
LLAMA_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))   # (out, in)
BIT_MIX = (0.05, 0.05)             # shares of 3- and 4-bit columns
SERVE_DEPTH = 16                   # layers of phases 4-7 and 9's llama1_7b
QUANT_DEPTH = 1                    # layers of the phase-8 model
GAMMA = 4                          # speculation window of the new phases
PAGE_SIZE = 16
PREFIX_LEN = 32                    # shared prompt prefix (2 whole pages)
PREFIX_SUFFIXES = (5, 9, 14, 20)   # its prompts: 37..52 tokens, bucket 64
PROMPT_LENS = (5, 17, 29, 42, 56, 70, 85, 100)
MAX_NEW = 16
PROFILE_STEP = 8                   # two decode steps from the 9th on run
#                                    under the profiler, once every prompt
#                                    is admitted (no prefill in the window)
PREEMPT_SEED = 3                   # 9a's pressure plan
GUARD_SEED = 1                     # 9b's NaN/Inf + transient-failure plan
CHUNK_PROMPT_LENS = (150, 180, 210, 240)   # 9c (+ MAX_NEW <= max_len)
CHUNK_TOKENS = 64
STORM = dict(seed=4, steps=12, step_ms=10.0, arrival_lambda=0.6,
             burst_every=4, burst_size=4, prompt_len=(20, 100),
             max_new=(4, 8), deadline_frac=0.0)    # 9d/9e arrival trace
STORM_TTFT_MS = 100.0              # 9d's SLO target (virtual ms)
TRAIN_STEPS = 20                   # phase 10's straight run
TRAIN_B, TRAIN_S = 4, 512          # its batch, and phase 8's eval batches
TRAIN_LR = 1e-3                    # warmup 5 steps, cosine to TRAIN_STEPS;
#                                    3e-3 and more diverge (PERF.md)
CKPT_STEP = 10                     # the async save, and the resume point
MICRO_STEP = 15                    # the one step at n_microbatches=2
PROFILE_TRAIN_STEP = 3             # two train steps from the 4th profiled
EVAL_BATCHES = 2                   # phase 8's perplexity batches
CPU_CHECK_THREADS = 3              # phase 8's CPU quantization, run beside
#                                    the mesh phases' ranks
MOE_DEPTH = 4                      # layers of phase 11's qwen3_moe_30b_a3b
RWKV_DEPTH = 8                     # layers of phase 12's rwkv6_7b
RWKV_CHECK_LEN = 100               # 12's chunked prefill vs recurrent decode
RING_PROMPT = 4200                 # 12b's long prompt (> attn_window 4096)
RING_MAX_LEN = 4608
RING_DECODE = 64                   # decode steps after it (each wraps)
ENCDEC_FRAMES = (4, 200)           # 12c's seeded frames: batch, S_src
ENCDEC_PROMPT = 8                  # its decoder prompt tokens
MESH_DEPTH = 1                     # layers of phase 14b's llama1_7b
MESH_SHAPES = ((1, 2), (2, 1))     # 14b's (data, model) meshes, 2 ranks
ROWSHARD_N = 512                   # 14d's matrix (rows = cols)
SPLIT_POOL_PAGES = 63              # 14f's pool: 64 page rows, 32 a rank
SPLIT_VIEW_STEP = 3                # the emitting step 14f checks views at
MESH_TRAIN_STEPS = 3               # 15a's steps on each mesh
MESH_TRAIN_TRACE = 2               # the step whose op trace 15a records
MOE_MESH_DEPTH = 1                 # layers of phase 16a's qwen3_moe_30b_a3b
MOE_MESH_ARCHS = ("qwen3_moe", "deepseek")   # 16a, 16b
MOE_TRAIN_STEPS = 3                # 16c's steps on each mesh
REPLAY_NOISE_STEPS = 4.0           # 16's forced replay: the largest logit
#                                    gap, in bf16 steps at the row's
#                                    largest logit (sound runs: <= 2.125)
REPLAY_ROUTER_NOISE = 4e-3         # its largest router probability gap
#                                    (sound runs: <= 2.19e-3)
REPLAY_FLIPS = 8                   # its argmax flips in 128 rows (sound
#                                    runs: <= 4)
RWKV_MESH_DEPTH = 2                # layers of phase 17a's rwkv6_7b
ZAMBA_MESH_DEPTH = 7               # layers of 17b's zamba2_1p2b: sites
#                                    before layers 0 and 6, two ring caches
RECURRENT_MESH_ARCHS = ("rwkv", "zamba2")      # 17a, 17b
RECURRENT_TRAIN_STEPS = 3          # 17c's steps on each mesh
# 17's forced replay, per family: the largest logit gap in bf16 steps at
# the row's largest logit, and the argmax flips in its 128 rows; each
# ceiling is twice the largest of the sound runs (NVIDIA H100 80GB HBM3
# at 700 W): ``tools/chip_phase17.py`` on prompt seeds 0, 7, 3 and 5 read
# at most 4.0 steps and 10 flips (seed 5) for rwkv, 17.5 steps and 12
# flips for zamba2; this script on phase 4's prompts 2.125 / 4 and
# 31.3125 / 4.  A flip needs a row whose top two logits lie within the
# noise, so the count follows the prompts.
RECURRENT_REPLAY_NOISE_STEPS = {"rwkv": 8.0, "zamba2": 64.0}
RECURRENT_REPLAY_FLIPS = {"rwkv": 20, "zamba2": 24}
ENCDEC_MESH_DEPTH = (12, 12)       # phase 18a's (encoder, decoder) layers
#                                    of seamless_m4t_medium: all of them
ENCDEC_TRAIN_STEPS = 3             # 18b's steps on each mesh
ENCDEC_TRAIN_S = TRAIN_S           # 18b's frames and tokens a row
# 18a's forced replay: the largest logit gap in bf16 steps at the row's
# largest logit, and the argmax flips in a rank's rows (68 on (1, 2), 34
# on (2, 1): 4 requests x 17 tokens); each ceiling is twice the largest
# of five sound runs (NVIDIA H100 80GB HBM3 at 700 W):
# ``tools/chip_phase18.py`` on seeds 0-4 read 2.84, 3.19, 2.63, 2.72 and
# 2.78 steps and at most 1, 1, 2, 3 and 2 flips
ENCDEC_REPLAY_NOISE_STEPS = 6.375
ENCDEC_REPLAY_FLIPS = 6
MLA_SMALL = dict(use_mla=True, q_lora=32, kv_lora=16, rope_head_dim=8,
                 v_head_dim=16, head_dim=16)   # phase 3's dense use_mla


def log(msg: str) -> None:
    print(msg, flush=True)


def card_memory(what: str) -> None:
    """Log the card's free memory (every process's use counted) and this
    process's allocated and reserved bytes, just before ``what``."""
    free, total = torch.cuda.mem_get_info()
    log(f"card memory before {what}: {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free; this process "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


# ----------------------------------------------------------------- weights

def synthetic_qt(rows, cols, gen, host_gen, device, bits=None, k_max=3):
    """A CLAQ AP+OR tensor built through the port's build_quantized_tensor
    from seeded parts: random codes, per-column sorted codebooks of
    2^bits normal draws scaled by cols^-0.5, column bits ~90 % 2 / 5 % 3 / 5 % 4 (or all ``bits``), and
    0..k_max reserved outliers per column."""
    from repro_torch.core.quantized import build_quantized_tensor
    column_bits = np.full(cols, 2 if bits is None else bits, np.int64)
    if bits is None:
        perm = torch.randperm(cols, generator=host_gen).numpy()
        n3, n4 = (max(1, round(s * cols)) for s in BIT_MIX)
        column_bits[perm[:n3]] = 3
        column_bits[perm[n3:n3 + n4]] = 4
    levels = torch.as_tensor(1 << column_bits, device=device)
    codes = torch.randint(0, 1 << 16, (rows, cols), generator=gen,
                          device=device) % levels[None, :]
    # a column's levels are its first 2^bits draws, sorted (masking after
    # the sort would keep the smallest of 16 draws: all negative, a common
    # direction that makes greedy decode repeat one token)
    cb = torch.randn((cols, 16), generator=gen, device=device) * cols ** -0.5
    cb = torch.sort(torch.where(torch.arange(16, device=device)[None, :]
                                < levels[:, None], cb, float("inf")),
                    dim=1).values
    counts = torch.randint(0, k_max + 1, (cols,), generator=host_gen).numpy()
    Q = torch.randn((rows, cols), generator=gen, device=device) \
        * (4 * cols ** -0.5)
    r0 = torch.randint(0, rows, (cols,), generator=gen, device=device)
    mask = torch.zeros((rows, cols), dtype=torch.bool, device=device)
    colj = torch.arange(cols, device=device)
    cnt = torch.as_tensor(counts, device=device)
    for j in range(k_max):              # k_max distinct rows per column
        sel = cnt > j
        mask[((r0 + j * (rows // k_max)) % rows)[sel], colj[sel]] = True
    return build_quantized_tensor(codes, cb, column_bits, counts, Q, mask)


def qt_to(qt, device):
    from repro_torch.core.quantized import QuantStripe
    return dataclasses.replace(
        qt, stripes=tuple(QuantStripe(s.packed.to(device),
                                      s.codebook.to(device), s.bits)
                          for s in qt.stripes),
        col_perm=qt.col_perm.to(device), out_idx=qt.out_idx.to(device),
        out_val=qt.out_val.to(device), out_count=qt.out_count.to(device))


def quantized_modules(model):
    """The modules of ``model`` whose kernel is a CLAQ tensor or plan."""
    return [m for m in model.modules() if hasattr(m, "kernel")
            and not isinstance(m.kernel, torch.Tensor)]


def synthetic_model(cfg, gen, host_gen, device, make_qt=synthetic_qt):
    """A model of any family whose block matmuls are synthetic CLAQ
    tensors, MoE experts stacked per layer (``BIT_MIX`` gives every expert
    the same stripe widths, so they stack); embedding, norms, the router,
    rwkv's decay LoRA, the hybrid's site LoRAs and lm_head stay dense, and
    the other leaves take the reference's init values."""
    from repro_torch.core.quantized import stack_quantized
    from repro_torch.models import layers as L
    from repro_torch.models import mla as mla_lib
    from repro_torch.models import modules as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    D, H, KH, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    dt = tf.torch_dtype(cfg)

    def q(out_dim, in_dim):
        return M.Dense(make_qt(out_dim, in_dim, gen, host_gen, device))

    def norm(n):
        return M.norm_scale_init(n, device=device)

    if cfg.family in ("rwkv", "hybrid", "encdec"):
        return _synthetic_family(cfg, gen, device, q, norm, dt)

    def experts(out_dim, in_dim):
        return M.Dense(stack_quantized([make_qt(out_dim, in_dim, gen,
                                                host_gen, device)
                                        for _ in range(cfg.n_experts)]))

    blocks = []
    for _ in range(cfg.n_layers):
        if cfg.use_mla:
            dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
            attn = mla_lib.MLA(q(cfg.q_lora, D), norm(cfg.q_lora),
                               q(H * (dn + dr), cfg.q_lora),
                               q(cfg.kv_lora + dr, D), norm(cfg.kv_lora),
                               q(H * (dn + dv), cfg.kv_lora), q(D, H * dv))
        else:
            attn = L.Attention(q(H * hd, D), q(KH * hd, D), q(KH * hd, D),
                               q(D, H * hd),
                               norm(hd) if cfg.qk_norm else None,
                               norm(hd) if cfg.qk_norm else None)
        if cfg.family == "moe":
            Fe = cfg.d_ff_expert
            Fs = Fe * cfg.n_shared_experts
            mlp = moe_lib.MoE(
                M.dense_init(gen, D, cfg.n_experts, device=device),
                experts(Fe, D), experts(Fe, D), experts(D, Fe),
                L.SwiGLU(q(Fs, D), q(Fs, D), q(D, Fs)) if Fs else None)
        else:
            mlp = L.SwiGLU(q(F, D), q(F, D), q(D, F))
        blocks.append(tf.Block(norm(D), norm(D), attn, mlp))
    emb = M.embed_init(gen, cfg.vocab, D, dt, device)
    head = M.dense_init(gen, D, cfg.vocab, dtype=dt, device=device)
    return tf.Transformer(emb, blocks, M.norm_scale_init(D, device=device),
                          head)


def _synthetic_family(cfg, gen, device, q, norm, dt):
    """``synthetic_model`` for rwkv, the hybrid and encdec (``q(out, in)``
    a synthetic CLAQ ``Dense``, ``norm(n)`` a unit scale)."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import modules as M
    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as tf
    D, H, KH, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    f32 = dict(dtype=torch.float32, device=device)
    emb = M.embed_init(gen, cfg.vocab, D, dt, device)
    head = M.dense_init(gen, D, cfg.vocab, dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), **f32)

    def attn():
        return L.Attention(q(H * hd, D), q(KH * hd, D), q(KH * hd, D),
                           q(D, H * hd))

    if cfg.family == "encdec":
        enc = [ed.EncBlock(norm(D), attn(), norm(D),
                           L.GeluMLP(q(F, D), q(D, F)))
               for _ in range(cfg.enc_layers)]
        dec = [ed.DecBlock(norm(D), attn(), norm(D),
                           ed.CrossAttention(q(H * hd, D), q(KH * hd, D),
                                             q(KH * hd, D), q(D, H * hd)),
                           norm(D), L.GeluMLP(q(F, D), q(D, F)))
               for _ in range(cfg.dec_layers)]
        return ed.EncDec(emb, enc, dec, norm(D), norm(D), head)
    blocks = []
    for _ in range(cfg.n_layers):
        if cfg.family == "rwkv":
            Hr, N = rwkv6.rwkv_dims(cfg)
            tm = rwkv6.TimeMix(
                0.5 * torch.ones((5, D), **f32), q(D, D), q(D, D), q(D, D),
                q(D, D), M.dense_init(gen, D, cfg.decay_lora, dtype=dt,
                                      device=device),
                M.dense_init(gen, cfg.decay_lora, D, dtype=dt, device=device,
                             scale=0.01),
                torch.full((D,), -1.0, **f32), torch.zeros((Hr, N), **f32),
                norm(D), zeros(D), q(D, D))
            cm = rwkv6.ChannelMix(0.5 * torch.ones((2, D), **f32), q(F, D),
                                  q(D, F), q(D, D))
            blocks.append(tf.RWKVBlock(norm(D), zeros(D), norm(D), zeros(D),
                                       tm, cm))
        else:
            d_inner, Hm, conv_dim = m2.mamba_dims(cfg)
            blocks.append(tf.HybridLayer(norm(D), m2.Mamba(
                q(2 * d_inner + 2 * cfg.ssm_state + Hm, D),
                (torch.randn((cfg.ssm_conv, conv_dim), generator=gen, **f32)
                 * 0.2).to(dt),
                torch.zeros((conv_dim,), dtype=dt, device=device),
                torch.log(torch.linspace(1.0, 16.0, Hm, **f32)), zeros(Hm),
                torch.ones((Hm,), **f32),
                M.norm_scale_init(d_inner, dt, device), q(D, d_inner))))
    if cfg.family == "rwkv":
        return tf.Transformer(emb, blocks, norm(D), head,
                              final_norm_bias=zeros(D))
    shared = tf.SharedAttention(q(H * hd, D), q(KH * hd, D), q(KH * hd, D),
                                q(D, H * hd), norm(D), norm(D),
                                L.SwiGLU(q(F, D), q(F, D), q(D, F)))
    sites = [tf.SiteLora(
        (torch.randn((D, tf.LORA_RANK), generator=gen, **f32)
         * D ** -0.5).to(dt),
        (torch.randn((tf.LORA_RANK, H * hd), generator=gen, **f32)
         * 0.01).to(dt)) for _ in range(cfg.n_sites)]
    return tf.Transformer(emb, blocks, norm(D), head, shared_attn=shared,
                          site_lora=sites)


# ----------------------------------------------------------------- timing

def time_ms(fn, reps, flush):
    """Mean device time of ``fn`` over ``reps`` runs, each after a write
    of ``flush`` (larger than the 50 MB L2) so every run starts cold, as
    the main path's weights do."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def graph_ms(fn, reps, flush):
    """Mean device time of ``fn`` captured in a CUDA graph and replayed
    ``reps`` times, each replay after a write of ``flush`` outside the graph
    (the chain's launches then run back to back, as no host enqueues them:
    this is the device's time alone)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    del graph
    return total / reps


def host_us_per_call(fn, calls, reps=20):
    """Host time to enqueue ``fn`` (``calls`` wrapper calls), per call, in
    microseconds: no synchronisation inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / (reps * calls) * 1e6


def chain_bytes_flops(pqt, m, x_itemsize):
    """Least bytes and FLOPs of one prepared matmul: every plan operand and
    x read once, y written once; 2 M N K operations."""
    n_bytes = m * pqt.cols * x_itemsize + m * pqt.n_padded * 4
    for g in pqt.groups:
        for t in (*g.planes, g.codebook, g.out_idx, g.out_val, g.x_idx):
            if t is not None:
                n_bytes += t.numel() * t.element_size()
    return n_bytes, 2 * m * pqt.rows * pqt.cols


def bound_of(n_bytes, flops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------------- phases

def phase_kernels(dm, ops, plan, ref, served, main_ms, gen, host_gen,
                  act="f32", modes=("aligned", "gathered", "blocked"),
                  dtypes=(torch.float32, torch.bfloat16)):
    """Kernel vs plain version at every M of ``main_ms`` and each of
    llama1_7b's matrix shapes; ``served`` maps (out, in) to a plan of the
    served model.  act="int8" runs K1e: x quantized per token, int8 x in
    every launch and the scale on the last (gather="kernel") or after the
    chain (blocked), also held within ``ref_act_int8_bound`` of the
    f32-activation kernel.  ``modes``/``dtypes`` narrow the cases (the
    served model's bf16 plans at phase 9's M values).  Returns the records
    and the largest error."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    cases = []
    max_err = 0.0
    for rows, cols in LLAMA_SHAPES:
        ap = served[(rows, cols)]
        single = plan.prepare_for_inference(
            synthetic_qt(rows, cols, gen, host_gen, "cuda", bits=2))
        assert [g.bits for g in ap.groups] == [2, 3, 4]
        assert all(g.x_start is None for g in ap.groups)
        assert single.x_gather_free
        w_ap, w_single = (p.dequantize(torch.float32) for p in (ap, single))
        for m in main_ms:
            x32 = torch.randn((m, cols), generator=gen, device="cuda")
            for mode, pqt, w_deq, gather in (
                    ("aligned", single, w_single, "kernel"),
                    ("gathered", ap, w_ap, "kernel"),
                    ("blocked", ap, w_ap, "xla")):
                if mode not in modes:
                    continue
                for dtype in dtypes:
                    x = x32.to(dtype)
                    scale = None
                    xk = x
                    if act == "int8":
                        xk, scale = ops.quantize_activations(x)
                    calls = list(ops.group_calls(xk, pqt, gather,
                                                 x_scale=scale))
                    # each launch against the plain version on the same
                    # inputs (its acc is the kernel's previous output)
                    acc = None
                    err = 0.0
                    for xg, kw in calls:
                        yk = dm.dequant_matmul(xg, acc=acc,
                                               compute_dtype=dtype, **kw)
                        yp = dm.dequant_matmul_plain(xg, acc=acc,
                                                     compute_dtype=dtype,
                                                     **kw)
                        torch.cuda.synchronize()
                        diff = (yk - yp).abs()
                        assert torch.isfinite(yk).all()
                        bad = diff > ATOL + RTOL * yp.abs()
                        assert not bad.any(), (rows, cols, m, mode, dtype,
                                               act, float(diff.max()))
                        err = max(err, float(diff.max()))
                        acc = yk

                    def run(fn, calls=calls, dtype=dtype):
                        y = None
                        for xg, kw in calls:
                            y = fn(xg, acc=y, compute_dtype=dtype, **kw)
                        return y

                    rec = {}
                    if act == "int8":
                        # int8 against f32 activations on the same kernel:
                        # within the quantization bound, + f32 sum slack
                        y8 = acc if gather == "kernel" else acc * scale
                        yf = None
                        for xg, kw in ops.group_calls(x, pqt, gather):
                            yf = dm.dequant_matmul(xg, acc=yf,
                                                   compute_dtype=dtype, **kw)
                        dev8 = (y8 - yf)[:, :rows].abs()
                        bound = ref.ref_act_int8_bound(x, w_deq.to(dtype))
                        assert bool((dev8 <= bound * 1.01 + ATOL).all()), (
                            rows, cols, m, mode, dtype,
                            float((dev8 - bound).max()))
                        rec = dict(int8_vs_f32_max=float(dev8.max()),
                                   int8_bound_max=float(bound.max()))

                    w_lib = w_deq.to(dtype)
                    ms = time_ms(lambda: run(dm.dequant_matmul), 10, flush)
                    dev_ms = graph_ms(lambda: run(dm.dequant_matmul), 10,
                                      flush)
                    host_us = host_us_per_call(
                        lambda: run(dm.dequant_matmul), len(calls))
                    plain_ms = time_ms(lambda: run(dm.dequant_matmul_plain),
                                       3, flush)
                    lib_ms = time_ms(lambda: torch.matmul(x, w_lib.T), 10,
                                     flush)
                    lib_dev_ms = graph_ms(lambda: torch.matmul(x, w_lib.T),
                                          10, flush)
                    nb, fl = chain_bytes_flops(pqt, m, xk.element_size())
                    if scale is not None:
                        nb += scale.numel() * scale.element_size()
                    bound_ms, by = bound_of(nb, fl, dtype)
                    max_err = max(max_err, err)
                    rec = dict(shape=f"{rows}x{cols}", m=m, x_mode=mode,
                               dtype=str(dtype).replace("torch.", ""),
                               act=act, launches=len(calls),
                               max_abs_err=err, ms=ms, device_ms=dev_ms,
                               host_us_per_call=host_us, plain_ms=plain_ms,
                               library_ms=lib_ms,
                               library_device_ms=lib_dev_ms,
                               bound_ms=bound_ms,
                               bound_by=by, bytes=nb, flops=fl, **rec)
                    cases.append(rec)
                    log("kernel " + json.dumps(rec))
        del ap, single, w_ap, w_single
    torch.cuda.empty_cache()
    return cases, max_err


def phase_small_reference(api, ServingEngine, cfg, gen, host_gen,
                          tag="dense"):
    """The same small synthetic CLAQ model on the card (kernel path) and on
    the CPU (the kernel's plain version): prefill logits within tolerance,
    greedy tokens equal except after a near tie."""
    cpu = synthetic_model(cfg, torch.Generator().manual_seed(SEED + 1),
                          torch.Generator().manual_seed(SEED + 2), "cpu")
    gpu = copy.deepcopy(cpu).to("cuda")          # moves the buffers
    for m in gpu.modules():
        if m in quantized_modules(gpu):
            m.kernel = qt_to(m.kernel, "cuda")
    prompts = [[1 + i, 5, 9, 2 + i, 7][: 3 + i] for i in range(3)]
    toks = np.zeros((2, 16), np.int64)
    toks[0, :5] = prompts[2]
    toks[1, :3] = prompts[0]
    at = torch.tensor([4, 2])
    lc, cc = api.prefill_step(cpu, cfg, {"tokens": torch.from_numpy(toks)},
                              api.make_cache(cfg, 2, 64, torch.float32,
                                             "cpu"), logits_at=at)
    lg, cg = api.prefill_step(gpu, cfg,
                              {"tokens": torch.from_numpy(toks).cuda()},
                              api.make_cache(cfg, 2, 64, torch.float32,
                                             "cuda"), logits_at=at.cuda())
    err = float((lg.cpu() - lc).abs().max())
    assert torch.isfinite(lg).all() and err < ATOL, err
    # three decode steps on the same tokens: logits stay within tolerance
    for _ in range(3):
        tok = lc.argmax(dim=-1)
        lc, cc = api.decode_step(cpu, cfg, tok, cc)
        lg, cg = api.decode_step(gpu, cfg, tok.cuda(), cg)
        step_err = float((lg.cpu() - lc).abs().max())
        assert torch.isfinite(lg).all() and step_err < ATOL, step_err
        err = max(err, step_err)
    out = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
        eng = ServingEngine(model, cfg, n_slots=2, max_len=64, min_bucket=8,
                            device=dev)
        order = []
        pending = list(prompts)
        while pending or eng.active:
            if pending and eng.free:
                order += eng.add_requests(
                    [pending.pop(0)
                     for _ in range(min(len(pending), len(eng.free)))],
                    max_new_tokens=8)
            eng.step()
        fin = eng.take_finished()
        out[tag] = [fin[u].tokens for u in order]
    for p, a, b in zip(prompts, out["cpu"], out["gpu"]):
        if a != b:
            j = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
            lgt, _, _ = api.tf.forward(cpu, cfg, torch.tensor([p + a[:j]]))
            top2 = torch.topk(lgt[0, -1], 2).values
            assert float(top2[0] - top2[1]) < ATOL, (p, a, b)
    log(f"small-model reference ({tag}): prefill + 3 decode steps, logits "
        f"max |gpu - cpu| = {err:.3e}"
        f"; greedy tokens gpu {out['gpu']} cpu {out['cpu']}")
    return gpu


def small_serve(eng, prompts, max_new=8):
    """Tokens of ``prompts`` (admitted as slots free up) in prompt order."""
    order, pending = [], list(prompts)
    while pending or eng.active or eng.pending_prefills:
        if pending and eng.free:
            n = min(len(pending), len(eng.free))
            order += eng.add_requests(pending[:n], max_new_tokens=max_new)
            del pending[:n]
        eng.step()
    fin = eng.take_finished()
    assert all(fin[u].state.value == "finished" for u in order)
    return [fin[u].tokens for u in order]


def phase_small_mla(api, ServingEngine, SpecConfig, cfg, model):
    """A dense ``use_mla`` smoke model on the card (K1; the latent cache):
    chunked prefill (8-token chunks) gives exactly the monolithic tokens,
    and speculation (a synthetic flat 2-bit draft, gamma 2) vanilla's
    except after a near tie (top-2 gap of vanilla's logits there below
    ATOL)."""
    prompts = [[1 + i, 5, 9, 2 + i, 7, 3, 8, 6, 4, 11][: 3 + 2 * i]
               for i in range(4)]
    kw = dict(n_slots=2, max_len=64, min_bucket=8, device="cuda")
    base = small_serve(ServingEngine(model, cfg, **kw), prompts)
    chunked = small_serve(ServingEngine(model, cfg, chunked_prefill=8, **kw),
                          prompts)
    assert chunked == base, (chunked, base)
    draft = synthetic_model(cfg, torch.Generator().manual_seed(SEED + 7),
                            torch.Generator().manual_seed(SEED + 7), "cpu",
                            make_qt=functools.partial(synthetic_qt, bits=2))
    draft = copy.deepcopy(draft).to("cuda")
    for m in quantized_modules(draft):
        m.kernel = qt_to(m.kernel, "cuda")
    eng = ServingEngine(model, cfg, draft_params=draft,
                        spec=SpecConfig(gamma=2), **kw)
    spec = small_serve(eng, prompts)
    ties = 0
    for p, a, b in zip(prompts, base, spec):
        if a != b:
            j = next(i for i, (u, v) in enumerate(zip(a, b)) if u != v)
            lg, _, _ = api.tf.forward(model, cfg,
                                      torch.tensor([p + a[:j]], device="cuda"))
            top2 = torch.topk(lg[0, -1].float(), 2).values
            assert float(top2[0] - top2[1]) < ATOL, (p, a, b)
            ties += 1
    st = eng.stats()
    log("small MLA (dense use_mla): chunked == monolithic tokens; "
        f"speculative windows {st['engine_steps']}, acceptance "
        f"{st['acceptance_rate']:.3f}, near-tie divergences {ties}; tokens "
        f"{base}")


def plan_launches(model, decode=False):
    """(launches, aligned launches) of one forward call of ``model``: one
    per distinct bit-width of each prepared matmul.  Stacked MoE experts
    are dequantized whole (no launch), and with ``decode`` MLA's kv_up is
    too (the absorbed decode and span materialize it).  The hybrid's
    shared block runs once a site, its ``o`` twice (the LoRA delta)."""
    skip = {id(b.attn.kv_up) for b in getattr(model, "blocks", ())
            if decode and hasattr(getattr(b, "attn", None), "kv_up")}
    calls = {}
    shared = getattr(model, "shared_attn", None)
    if shared is not None:
        calls = {id(m): len(model.site_lora)
                 for m in quantized_modules(shared)}
        calls[id(shared.o)] = 2 * len(model.site_lora)
    groups = [g for m in quantized_modules(model)
              if id(m) not in skip and not m.kernel.stack
              for g in m.kernel.groups * calls.get(id(m), 1)]
    return len(groups), sum(g.x_start is not None for g in groups)


def drive(eng, prompts, dm, api, cfg, tag, one_by_one=False,
          prefill_rows=False):
    """Serve ``prompts`` through ``eng`` (admitted as slots free up, or
    one per admission call with ``one_by_one``; ``MAX_NEW`` tokens each),
    with the launch counts set to 0 just before and read just after.
    Asserts every request finished, the launches of every prefill call and
    step (one per distinct bit-width per matmul: the target's, plus the
    draft's prefill and its gamma+1 decodes a window under speculation,
    aligned and gathered apart) and no plain version; returns the record
    (tokens in prompt order under "tokens"; a vanilla engine's decode
    logits under "decode_logits": per request, token position -> the f32
    logits row that decode step emitted it from; with ``prefill_rows``,
    each prompt's batch-1 prefill row under "prefill_logits")."""
    t_lpm, t_al = plan_launches(eng.params)
    t_dec, t_dal = plan_launches(eng.params, decode=True)
    d_lpm, d_al = (plan_launches(eng.draft_params) if eng.spec is not None
                   else (0, 0))
    d_dec, d_dal = (plan_launches(eng.draft_params, decode=True)
                    if eng.spec is not None else (0, 0))
    draft_calls = eng.spec.gamma + 1 if eng.spec is not None else 0
    per_step = t_dec + draft_calls * d_dec
    per_prefill = t_lpm + d_lpm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm.launch_count = dm.int8_launch_count = dm.plain_count = 0
    dm.aligned_launch_count = 0
    prefill_s, decode_s, decode_tok, decode_launches = [], [], [], []
    prefill_calls = 0
    order = []
    pending = list(prompts)
    prof, prof_s, steps = None, None, 0
    rows = {}
    rec = DecodeLogits(api, eng.spec is None)
    t_run = time.perf_counter()
    while pending or eng.active:
        if pending and eng.free:
            n = 1 if one_by_one else min(len(pending), len(eng.free))
            batch = [pending.pop(0) for _ in range(n)]
            calls = sum(eng.bucketing.stats.per_shape.values())
            t0 = time.perf_counter()
            order += eng.add_requests(batch, max_new_tokens=MAX_NEW)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            prefill_calls += (sum(eng.bucketing.stats.per_shape.values())
                              - calls)
        before = dm.launch_count
        if steps >= PROFILE_STEP and prof is None and not pending:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_from = len(decode_launches)
            t_prof = time.perf_counter()
        at = {uid: (r.slot, len(r.tokens)) for uid, r in eng.active.items()}
        t0 = time.perf_counter()
        with rec:
            emitted = eng.step()
        torch.cuda.synchronize()
        if emitted:
            steps += 1
            decode_launches.append(dm.launch_count - before)
            if prof is not None and prof_s is None:
                if len(decode_launches) == prof_from + 2:   # two steps
                    prof_s = time.perf_counter() - t_prof
                    prof.stop()
            else:
                decode_s.append(time.perf_counter() - t0)
                decode_tok.append(sum(len(v) if isinstance(v, list) else 1
                                      for v in emitted.values()))
            rec.file(rows, at, emitted)
    if prof is not None and prof_s is None:        # the run ended first
        prof.stop()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches, int8_launches = dm.launch_count, dm.int8_launch_count
    aligned = dm.aligned_launch_count
    main_plain = dm.plain_count
    peak = torch.cuda.max_memory_allocated()

    fin = eng.take_finished()
    assert sorted(fin) == sorted(order) and len(fin) == len(prompts)
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == MAX_NEW for u in order)
    assert main_plain == 0, "the main path ran the plain version on the card"
    assert set(decode_launches) == {per_step}, (set(decode_launches),
                                                per_step)
    assert launches == per_prefill * prefill_calls + per_step * len(
        decode_launches)
    assert aligned == (prefill_calls * (t_al + d_al) + len(decode_launches)
                       * (t_dal + draft_calls * d_dal)), aligned
    assert int8_launches == (launches if eng.act_dtype == "int8" else 0)
    # logits of the served model: finite, of the expected shape
    from repro_torch.models.modules import activation_quant
    with activation_quant(eng.act_dtype):
        logits, _ = api.prefill_step(
            eng.params, cfg,
            {"tokens": torch.tensor([prompts[0]], device="cuda")},
            api.make_cache(cfg, 1, eng.max_len, torch.bfloat16, "cuda"))
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()

    tokens = sum(len(fin[u].tokens) for u in order)
    stats = eng.stats()
    profile = device_profile(prof, prof_s)
    # a decode runs every slot (a verify n_slots * (gamma+1) rows); a
    # prefill of shape (Bb, bucket) runs Bb*bucket
    kernel_m = sorted({eng.n_slots} | {b * n for b, n
                                       in eng.bucketing.stats.per_shape}
                      | ({eng.n_slots * (eng.spec.gamma + 1)}
                         if eng.spec is not None else set()))
    res = dict(act_dtype=stats["act_dtype"], requests=len(order),
               new_tokens=tokens, prefill_calls=prefill_calls,
               prefill_ms=sum(prefill_s) * 1e3, decode_steps=len(decode_s),
               decode_ms_per_step=float(np.mean(decode_s)) * 1e3,
               decode_ms_per_step_min=float(np.min(decode_s)) * 1e3,
               decode_ms_per_token=sum(decode_s) / sum(decode_tok) * 1e3,
               tokens_per_s=tokens / run_s, run_s=run_s,
               launches_per_decode_step=per_step,
               launches_per_prefill_call=per_prefill,
               main_path_launches=launches,
               main_path_int8_launches=int8_launches,
               main_path_aligned_launches=aligned,
               main_path_gathered_launches=launches - aligned,
               max_memory_allocated_gb=peak / 1e9,
               prefill_shapes=stats["prefill_traces"],
               prefill_batch_bucket=sorted(eng.bucketing.stats.per_shape),
               decode_m=eng.n_slots, kernel_m=kernel_m,
               profile_two_decode_steps=profile)
    for key in ("spec_gamma", "acceptance_rate", "spec_drafted",
                "spec_accepted", "tokens_per_step", "engine_steps"):
        if key in stats and (eng.spec is not None or key == "engine_steps"):
            res[key] = stats[key]
    if "paged" in stats:
        res["paged"] = stats["paged"]
    log(tag + " " + json.dumps(res))
    res["tokens"] = [fin[u].tokens for u in order]
    if eng.spec is None:
        res["decode_logits"] = [rows[u] for u in order]
        assert all(sorted(r) == list(range(1, MAX_NEW))
                   for r in res["decode_logits"])
    if prefill_rows:
        res["prefill_logits"] = prefill_logits(api, eng, cfg, prompts)
    log("sample tokens: " + str([t[:8] for t in res["tokens"][:2]]))
    return res


def prefill_logits(api, eng, cfg, prompts):
    """Each prompt's logits row from a batch-1 prefill on ``eng``'s
    params (f32), the row a first-token divergence is judged on."""
    from repro_torch.models.modules import activation_quant
    out = []
    with torch.no_grad(), activation_quant(eng.act_dtype):
        for p in prompts:
            lg, _ = api.prefill_step(
                eng.params, cfg, {"tokens": torch.tensor([p], device="cuda")},
                api.make_cache(cfg, 1, eng.max_len, torch.bfloat16, "cuda"))
            out.append(lg[0].float())
    return out


class DecodeLogits:
    """Keep a vanilla engine's decode logits: while open (and ``on``),
    ``api.decode_step`` leaves its logits in ``last``; ``file`` then puts
    each emitting request's row under (uid, token position), checking that
    the row's argmax is the token the engine emitted."""

    def __init__(self, api, on):
        self.api, self.inner, self.on, self.last = api, api.decode_step, on, None

    def __enter__(self):
        if self.on:
            def recorded(*a, **k):
                out = self.inner(*a, **k)
                self.last = out[0]
                return out
            self.api.decode_step = recorded
        return self

    def __exit__(self, *exc):
        self.api.decode_step = self.inner

    def file(self, rows, at, emitted):
        if not self.on:
            return
        for uid, tok in emitted.items():
            slot, j = at[uid]
            row = self.last[slot].float().clone()
            assert int(row.argmax()) == tok, (uid, j, tok)
            rows.setdefault(uid, {})[j] = row


def device_profile(prof, wall_s):
    """Device-busy share of a profiled window (the kernels' device time
    over its wall time; one stream, so kernels do not overlap) and the top
    kernels by device time, or "not measured" where the profiler saw no
    device time."""
    if prof is None or not wall_s:
        return "not measured"
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda
               and getattr(e, "device_time_total", 0) > 0]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us <= 0:
        return "not measured"
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    return dict(
        window_ms=wall_s * 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / 1e3 / (wall_s * 1e3),
        host_share=1.0 - busy_us / 1e3 / (wall_s * 1e3),
        top_kernels=[dict(name=e.key[:90], count=e.count,
                          device_ms=e.device_time_total / 1e3)
                     for e in top])


def phase_serve(api, dm, ServingEngine, module_tensors, cfg, gen, host_gen):
    """Full-width llama1_7b through the engine; returns its record (the
    main-path launch count, timings, and ``kernel_m``: every M it gave
    K1), the served model and the prompts."""
    log("weights: SYNTHETIC CLAQ AP+OR tensors built on the card from seed "
        f"{SEED}; ~90 % 2-bit, 5 % 3-bit, 5 % 4-bit columns, 0-3 reserved "
        "outliers per column")
    t0 = time.perf_counter()
    model = synthetic_model(cfg, gen, host_gen, "cuda")
    torch.cuda.synchronize()
    qmods = quantized_modules(model)
    assert len(qmods) == 7 * cfg.n_layers == 7 * SERVE_DEPTH, len(qmods)
    packed = sum(s.packed.numel() * 4 for m in qmods
                 for s in m.kernel.stripes)
    eff = np.mean([m.kernel.effective_bits() for m in qmods])
    log(f"built {len(qmods)} CLAQ matrices in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"packed codes {packed / 1e9:.3f} GB, mean effective bits "
        f"{eff:.3f}")

    t0 = time.perf_counter()
    eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"engine init (plans for {len(qmods)} matrices): "
        f"{time.perf_counter() - t0:.1f} s")
    assert all(t.is_cuda for t in module_tensors(model))
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=host_gen).tolist()
               for n in PROMPT_LENS]
    return (drive(eng, prompts, dm, api, cfg, "serve", prefill_rows=True),
            model, prompts)


def phase_serve_int8(api, dm, ServingEngine, cfg, model, prompts):
    """The phase-4 model (its plans already prepared) served again with
    int8 activations on the same prompts."""
    eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, act_dtype="int8",
                        device="cuda")
    return drive(eng, prompts, dm, api, cfg, "serve_int8")


class SpanNoise:
    """While open, measure every speculative verify before it runs: the
    largest |verify - successive decode| logit gap on its inputs, one
    float per window in ``gaps`` (``act``: the engine's activations)."""

    def __init__(self, api, act):
        self.api, self.act, self.gaps = api, act, []
        self.span, self.step = api.decode_span, api.decode_step

    def __enter__(self):
        def measured(params, cfg, tokens, cache):
            self.gaps.append(verify_vs_decode(
                self.span, self.step, params, cfg, self.act, tokens, cache))
            return self.span(params, cfg, tokens, cache)
        self.api.decode_span = measured
        return self

    def __exit__(self, *exc):
        self.api.decode_span = self.span


def clone_cache(cache):
    return [type(c)(*(None if t is None else t.clone() for t in c))
            for c in cache]


def verify_vs_decode(span, step, params, cfg, act, tokens, cache):
    """Largest |verify - successive decode| logit difference on one
    window's inputs (rows of occupied slots): the span call against its
    gamma+1 decode steps, each from a copy of the same cache."""
    from repro_torch.models.modules import activation_quant
    rows = cache[0].length > 0
    with torch.no_grad(), activation_quant(act):
        vl, _ = span(params, cfg, tokens, clone_cache(cache))
        c, outs = clone_cache(cache), []
        for j in range(tokens.shape[1]):
            lg, c = step(params, cfg, tokens[:, j], c)
            outs.append(lg)
    return float((vl - torch.stack(outs, dim=1))[rows].abs().max())


def near_tie_limit(api, eng, prompts, act, timed):
    """The near-tie limit of a speculative run: an untimed second serve of
    ``prompts`` on ``eng`` (a fresh engine like the timed run's, admitted
    as ``drive`` admits, so the same windows: its tokens must equal the
    timed run's record ``timed``) with every window measured by
    ``SpanNoise``.  Returns (twice the largest gap, the gap, windows)."""
    pending, order = list(prompts), []
    with SpanNoise(api, act) as noise:
        while pending or eng.active:
            if pending and eng.free:
                n = min(len(pending), len(eng.free))
                order += eng.add_requests([pending.pop(0) for _ in range(n)],
                                          max_new_tokens=MAX_NEW)
            eng.step()
    fin = eng.take_finished()
    assert [fin[u].tokens for u in order] == timed["tokens"], \
        "the measuring serve left the timed one"
    diff = max(noise.gaps)
    return 2 * diff, diff, len(noise.gaps)


def near_ties(got, base, limit, tag, ulps=0):
    """Hold speculative tokens ``got`` against vanilla's (``base``: a
    vanilla ``drive`` record), request by request.  At a divergence,
    vanilla's own decode logits at that position (the row its decode step
    emitted the token from) must show a near tie: their top-2 gap, and the
    speculative token's deficit to their maximum, both below ``limit``
    (twice the largest |verify - successive decode| logit difference).
    A divergence at the first token reads the prompt's batch-1 prefill
    row (``prefill_logits``); a shorter ``got`` (a quarantined request) is
    held to vanilla's prefix.  ``ulps`` > 0 raises the limit at a
    divergence to that many bf16 steps at the row's largest logit: any
    change of a reduction's order can move a bf16 logit by a step, so two
    logits that close are a tie at the logits' own resolution.  Returns
    the divergences."""
    out = []
    for i, (g, w, rows) in enumerate(zip(got, base["tokens"],
                                         base["decode_logits"])):
        if g == w[:len(g)]:          # equal, or a quarantined prefix
            continue
        j = next(k for k, (a, b) in enumerate(zip(g, w)) if a != b)
        if j == 0:
            # the first token comes from a prefill: its row at batch 1
            assert "prefill_logits" in base, (tag, i, "diverged at prefill")
            row = base["prefill_logits"][i]
        else:
            assert j in rows, (tag, i, j, "vanilla emitted it from prefill")
            row = rows[j]
        top2 = torch.topk(row, 2).values
        lim = limit
        if ulps:
            top = float(row.abs().max())
            lim = max(limit, ulps * 2.0 ** (np.floor(np.log2(top)) - 7))
        out.append(dict(request=i, position=j, vanilla_token=w[j],
                        spec_token=g[j], gap=float(top2[0] - top2[1]),
                        spec_token_deficit=float(top2[0] - row[g[j]]),
                        limit=lim))
        log(f"{tag}: request {i} diverges from vanilla at token {j}: "
            + json.dumps(out[-1]))
    assert all(d["gap"] < d["limit"] and d["spec_token_deficit"]
               < d["limit"] for d in out), out
    return out


def phase_spec_serve(api, dm, ServingEngine, SpecConfig, cfg, model,
                     prompts, base):
    """The phase-4 target served speculatively (gamma ``GAMMA``) with a
    synthetic flat 2-bit + OR draft of the same shapes from its own seed
    (acceptance near 0: the point is losslessness at full width).  Tokens
    held against phase 4's under the near-tie rule; returns the record,
    the draft and the near-tie limit."""
    t0 = time.perf_counter()
    draft = synthetic_model(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 5), torch.Generator().manual_seed(SEED + 5), "cuda",
        make_qt=functools.partial(synthetic_qt, bits=2))
    torch.cuda.synchronize()
    log(f"built the synthetic 2-bit + OR draft in "
        f"{time.perf_counter() - t0:.1f} s")
    def engine():
        return ServingEngine(model, cfg, n_slots=4, max_len=256,
                             dtype=torch.bfloat16, draft_params=draft,
                             spec=SpecConfig(gamma=GAMMA), device="cuda")
    res = drive(engine(), prompts, dm, api, cfg, "spec_serve")
    limit, diff, windows = near_tie_limit(api, engine(), prompts, None, res)
    div = near_ties(res["tokens"], base, limit, "spec_serve")
    res.update(verify_vs_decode_max_abs=diff, near_tie_limit=limit,
               verify_windows_measured=windows, divergences=len(div),
               divergence_records=div)
    log("spec_serve near ties " + json.dumps(dict(
        verify_vs_decode_max_abs=diff, near_tie_limit=limit,
        verify_windows_measured=windows, divergences=div,
        windows=res["engine_steps"], acceptance_rate=res["acceptance_rate"],
        ms_per_emitted_token=res["decode_ms_per_token"],
        aligned_launches=res["main_path_aligned_launches"],
        gathered_launches=res["main_path_gathered_launches"])))
    return res, draft, limit


def self_draft(api, dm, ServingEngine, SpecConfig, cfg, model, prompts,
               base, limit, tag, **kw):
    """The phase-4 target as its own draft (``kw``: the cache layout): its
    draft decodes are vanilla's, so windows accept nearly every draft
    token and emit several tokens, reaching the verify's later rows, the
    rollback by k > 0 and (paged) the tail pages later windows reuse.
    Tokens held to phase 4's under the near-tie rule."""
    res = drive(ServingEngine(model, cfg, n_slots=4, max_len=256,
                              dtype=torch.bfloat16, draft_params=model,
                              spec=SpecConfig(gamma=GAMMA), device="cuda",
                              **kw), prompts, dm, api, cfg, tag)
    div = near_ties(res["tokens"], base, limit, tag)
    assert res["acceptance_rate"] > 0.5, res["acceptance_rate"]
    assert res["tokens_per_step"] > 4, res["tokens_per_step"]
    res.update(divergences=len(div), divergence_records=div)
    log(tag + " windows " + json.dumps(dict(
        windows=res["engine_steps"], acceptance_rate=res["acceptance_rate"],
        tokens_per_window=res["tokens_per_step"], divergences=div,
        ms_per_emitted_token=res["decode_ms_per_token"])))
    return res


def phase_paged_serve(api, dm, ServingEngine, SpecConfig, cfg, model,
                      prompts, base, spec, spec_self, draft, limit,
                      host_gen):
    """The phase-4 model from a page pool (``PAGE_SIZE``-token pages):
    capacity-equivalent fp (tokens exactly phase 4's), int8 (budgets kept,
    under 1/3 of an f32 page's bytes, tokens counted), prompts sharing a
    ``PREFIX_LEN``-token prefix (prefix hits, fewer pages than without
    sharing, tokens exactly the contiguous engine's on the same schedule)
    and speculation on the fp pool, with the synthetic draft and with the
    target as its own draft (phase 4's tokens under the near-tie rule,
    phase 4b's exactly).
    Returns the records by sub-phase."""
    kw = dict(n_slots=4, max_len=256, dtype=torch.bfloat16, device="cuda")
    paged = dict(kw, kv_layout="paged", page_size=PAGE_SIZE)
    out = {}
    out["paged_serve"] = fp = drive(ServingEngine(model, cfg, **paged),
                                    prompts, dm, api, cfg, "paged_serve")
    assert fp["tokens"] == base["tokens"], "paged fp != contiguous tokens"

    out["paged_int8_serve"] = i8 = drive(
        ServingEngine(model, cfg, kv_dtype="int8", **paged), prompts, dm,
        api, cfg, "paged_int8_serve")
    # int8 pages against f32 pages (the reference's 1/3 bound) and
    # against the bf16 pages this model serves from
    f32_page = ServingEngine(model, cfg, **dict(
        paged, dtype=torch.float32)).stats()["paged"]["bytes_per_page"]
    ratio = i8["paged"]["bytes_per_page"] / f32_page
    assert ratio < 1 / 3, ratio
    same = [g == b for g, b in zip(i8["tokens"], base["tokens"])]
    first = [next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
             for g, w in zip(i8["tokens"], base["tokens"])]
    i8.update(bytes_per_page_vs_f32=ratio,
              bytes_per_page_vs_bf16=(i8["paged"]["bytes_per_page"]
                                      / fp["paged"]["bytes_per_page"]),
              requests_equal_to_fp=sum(same), first_divergence=first)
    log("paged_int8_serve vs phase 4 " + json.dumps({k: i8[k] for k in (
        "bytes_per_page_vs_f32", "bytes_per_page_vs_bf16",
        "requests_equal_to_fp", "first_divergence")}))

    prefix = torch.randint(1, cfg.vocab, (PREFIX_LEN,),
                           generator=host_gen).tolist()
    shared = [prefix + torch.randint(1, cfg.vocab, (n,),
                                     generator=host_gen).tolist()
              for n in PREFIX_SUFFIXES]
    runs = {}
    for tag, eng in (
            ("paged_prefix_serve", ServingEngine(model, cfg, **paged)),
            ("paged_prefix_private", ServingEngine(
                model, cfg, share_prefixes=False, **paged)),
            ("prefix_contiguous", ServingEngine(model, cfg, **kw))):
        runs[tag] = drive(eng, shared, dm, api, cfg, tag, one_by_one=True)
    sh, pr = (runs[t]["paged"] for t in ("paged_prefix_serve",
                                         "paged_prefix_private"))
    assert sh["prefix_hits"] > 0, sh
    assert sh["peak_pages_in_use"] < pr["peak_pages_in_use"], (sh, pr)
    assert runs["paged_prefix_serve"]["tokens"] == \
        runs["prefix_contiguous"]["tokens"], "shared prefix != contiguous"
    out["paged_prefix_serve"] = runs["paged_prefix_serve"]
    out["paged_prefix_serve"].update(
        peak_pages_private=pr["peak_pages_in_use"],
        contiguous_ms_per_token=runs["prefix_contiguous"][
            "decode_ms_per_token"])
    log("paged_prefix_serve " + json.dumps(dict(
        prefix_hits=sh["prefix_hits"],
        prefix_shared_tokens=sh["prefix_shared_tokens"],
        cow_copies=sh["cow_copies"],
        peak_pages_shared=sh["peak_pages_in_use"],
        peak_pages_private=pr["peak_pages_in_use"])))

    out["paged_spec_serve"] = sp = drive(
        ServingEngine(model, cfg, draft_params=draft,
                      spec=SpecConfig(gamma=GAMMA), **paged),
        prompts, dm, api, cfg, "paged_spec_serve")
    div = near_ties(sp["tokens"], base, limit, "paged_spec_serve")
    # fp pages change no bit, so phase 4b's tokens come back exactly
    assert sp["tokens"] == spec["tokens"], "paged != contiguous speculation"
    sp.update(divergences=len(div), divergence_records=div)

    # the self-draft on pages: windows that accept, so rollbacks by k > 0
    # and tail pages that later windows write again
    out["paged_spec_self_serve"] = ss = self_draft(
        api, dm, ServingEngine, SpecConfig, cfg, model, prompts, base, limit,
        "paged_spec_self_serve", kv_layout="paged", page_size=PAGE_SIZE)
    assert ss["tokens"] == spec_self["tokens"], \
        "paged != contiguous self-draft speculation"
    return out


def codes_of(qt):
    """Codes of a QuantizedTensor, (rows, cols) in original column order
    (the order GPTQ quantized them in)."""
    from repro_torch.core import packing
    c = torch.cat([packing.unpack_codes(s.packed, s.bits, qt.rows)
                   for s in qt.stripes], dim=1)
    out = torch.empty_like(c)
    out[:, qt.col_perm.long()] = c
    return out


def quantize_on_cpu(W, H, qcfg, threads):
    """Phase 8's CPU side of the card-vs-CPU check, run in a process of
    its own beside the mesh phases: W and H (CPU tensors) quantized on
    ``threads`` threads.  Returns (column bits, reserve
    counts, codes in original column order as uint8, proxy loss,
    seconds)."""
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(threads)
    from repro_torch.core import claq as claq_lib
    plan = claq_lib.plan_matrix(W, qcfg)
    t0 = time.perf_counter()
    q, _, stats = claq_lib.quantize_matrix(W, H, qcfg, plan)
    return (plan.column_bits, plan.reserve_counts,
            codes_of(q).to(torch.uint8), stats.proxy_loss,
            time.perf_counter() - t0)


def quantize_on_card(claq_lib, W, H, qcfg):
    """The card's side of the check, W and H on the card: the same tuple
    as ``quantize_on_cpu``, the codes on the host."""
    plan = claq_lib.plan_matrix(W, qcfg)
    t0 = time.perf_counter()
    q, _, stats = claq_lib.quantize_matrix(W, H, qcfg, plan)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (plan.column_bits, plan.reserve_counts,
            codes_of(q).cpu().to(torch.uint8), stats.proxy_loss, secs)


def card_vs_cpu(card, cpu):
    """Hold the same W and H quantized on the card and on the CPU (each a
    ``quantize_on_card`` / ``quantize_on_cpu`` tuple): plans must be
    equal; returns the share of equal codes (all, the first 512 columns,
    and by quarter of the columns in GPTQ order) and both proxy losses."""
    assert np.array_equal(card[0], cpu[0])
    assert np.array_equal(card[1], cpu[1])
    eq = (card[2] == cpu[2]).float()
    q = eq.shape[1] // 4
    lg, lc = card[3], cpu[3]
    return dict(codes_equal=float(eq.mean()),
                codes_equal_first_512=float(eq[:, :512].mean()),
                codes_equal_by_quarter=[float(eq[:, i * q:(i + 1) * q].mean())
                                        for i in range(4)],
                proxy_loss_card=lg, proxy_loss_cpu=lc,
                proxy_loss_rel_diff=abs(lg - lc) / abs(lc),
                card_s=card[4], cpu_s=cpu[4])


def quantize_pipeline(claq_lib, lq, model, dcfg, calib, qcfg):
    """The launcher's pipeline on the card (``--bits 2.2 --spec-gamma``):
    one calibration, the 2-bit draft then the target, timed per matrix.
    Returns (seconds, seconds per matrix, target, its report, draft, its
    report)."""
    seconds = {"draft": {}, "target": {}}
    inner = claq_lib.quantize_matrix
    n_mats = 7 * QUANT_DEPTH
    done = []

    def timed(W, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner(W, *a, **k)
        torch.cuda.synchronize()
        part = "draft" if len(done) < n_mats else "target"
        seconds[part].setdefault("x".join(map(str, W.shape)), []).append(
            time.perf_counter() - t)
        done.append(1)
        return r

    claq_lib.quantize_matrix = timed
    try:
        t0 = time.perf_counter()
        (model, report), (draft, drep) = lq.claq_quantize_with_draft(
            model, dcfg, calib, qcfg, draft_bits=2)
        quant_s = time.perf_counter() - t0
    finally:
        claq_lib.quantize_matrix = inner
    torch.cuda.empty_cache()
    assert len(done) == 2 * n_mats
    return quant_s, seconds, model, report, draft, drep


def phase8_qcfg():
    """Phase 8's recipe (``--bits 2.2``): K-Means, 6 iterations, GPTQ
    blocks of 32, AP 2.2 over 2-4 bits."""
    from repro_torch.core import APConfig, CLAQConfig
    return CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4))


def start_card_vs_cpu(pool, model):
    """Phase 8's card-vs-CPU matrix, made as soon as phase 10 has trained
    ``model``: its first q matrix and a full-rank Hessian (Gaussian
    activations, 16384 rows) on the card, and the CPU's quantization of
    them submitted to ``pool`` on ``CPU_CHECK_THREADS`` threads (it runs
    beside the mesh phases, which leave the host's other cores idle).
    Returns (W, H, the CPU's future)."""
    W = model.blocks[0].attn.q.kernel.float().T.contiguous()
    X = torch.randn((16384, W.shape[1]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 4))
    gauss = 2.0 * (X.T @ X) / X.shape[0]
    del X
    return W, gauss, pool.submit(quantize_on_cpu, W.cpu(), gauss.cpu(),
                                 phase8_qcfg(), CPU_CHECK_THREADS)


def phase_quantize_serve(api, dm, ServingEngine, SpecConfig, cfg, prompts,
                         model, card_vs_cpu_inputs):
    """Quantize phase 10's trained full-width llama1_7b (``QUANT_DEPTH``
    layers) on the card with the launcher's recipe for ``--bits 2.2
    --spec-gamma``: one calibration, a 2-bit draft and the AP target
    (``claq_quantize_with_draft``); hold one 4096x4096 matrix against the
    CPU (``card_vs_cpu_inputs``: ``start_card_vs_cpu``'s W, H and the
    CPU's future); print perplexity on ``EVAL_BATCHES`` batches (B
    ``TRAIN_B``, S ``TRAIN_S``) for fp, RTN uniform 2-bit (dense), the
    draft and the target (K1 blocked at M = B * S, launches counted);
    serve the target with int8 activations, then the pair speculatively
    (tokens held to the target's under the near-tie rule).  Returns the
    record."""
    from repro_torch.core import rtn_quantize_matrix
    from repro_torch.core import claq as claq_lib
    from repro_torch.data import DataConfig, SyntheticCorpus, calibration_set
    from repro_torch.launch import quantize as lq

    qcfg = phase8_qcfg()
    dcfg = dataclasses.replace(cfg, n_layers=QUANT_DEPTH)
    assert len(model.blocks) == QUANT_DEPTH
    evals = [SyntheticCorpus(DataConfig(dcfg.vocab, TRAIN_S, TRAIN_B,
                                        seed=SEED + 123)).batch_at(10_000 + i)
             for i in range(EVAL_BATCHES)]
    ppl = {"fp": perplexity(api, dcfg, model, evals)}
    rtn = copy.deepcopy(model)
    for blk in rtn.blocks:
        for _, m in lq.block_matrices(blk):
            Q, _, _ = rtn_quantize_matrix(m.kernel.float().T, 2, "uniform")
            m.set_kernel(Q.T.to(m.kernel.dtype).contiguous())
    ppl["rtn_uniform_2bit"] = perplexity(api, dcfg, rtn, evals)
    del rtn
    calib = calibration_set(dcfg.vocab, n_segments=8, seq_len=64)
    t0 = time.perf_counter()
    hessians = lq.calibrate(model, dcfg, calib)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    assert len(hessians) == 7 * QUANT_DEPTH + 1, sorted(hessians)

    # the same matrix and Hessian on the card and on the CPU.  GPTQ's error
    # feedback carries the devices' last-bit differences from column to
    # column: a code that flips moves every later column of its row.  So
    # codes are held to >= 99 % equal over the first 512 columns and the
    # proxy loss to 1e-3, on a full-rank Hessian (Gaussian activations,
    # 16384 rows).  (Layer 0's calibration Hessians have rank <= the
    # number of distinct tokens and agree less; PERF.md keeps their
    # reading, which is left out here for the script's time.)  The CPU's
    # side has run in a process of its own since phase 10
    # (``start_card_vs_cpu``).
    del hessians
    W, gauss, on_cpu = card_vs_cpu_inputs
    on_card = quantize_on_card(claq_lib, W, gauss, qcfg)
    del W, gauss, card_vs_cpu_inputs
    quant_s, seconds, model, report, draft, drep = quantize_pipeline(
        claq_lib, lq, model, dcfg, calib, qcfg)
    full = card_vs_cpu(on_card, on_cpu.result())
    checks = {"gaussian_16384_rows": full}
    log("quantize card-vs-cpu 4096x4096 gaussian_16384_rows "
        + json.dumps(full))
    assert full["codes_equal_first_512"] >= 0.99, full
    assert full["proxy_loss_rel_diff"] <= 1e-3, full
    n_mats = 7 * QUANT_DEPTH
    assert len(report.stats) == len(drep.stats) == n_mats
    assert 2.15 < report.mean_effective_bits < 2.25, report.mean_effective_bits
    assert 2.0 <= drep.mean_effective_bits < report.mean_effective_bits
    assert draft.embedding is model.embedding
    # perplexity of the draft and the target before the engine prepares
    # their plans: the unprepared path runs K1 blocked, once per stripe of
    # each matrix, at M = B * S
    reset_counts(dm)
    ppl["draft_2bit"] = perplexity(api, dcfg, draft, evals)
    ppl["target_ap2.2"] = perplexity(api, dcfg, model, evals)
    eval_counts = read_counts(dm)
    stripes = sum(len(m.kernel.stripes) for mod in (draft, model)
                  for m in quantized_modules(mod))
    assert eval_counts["launches"] == stripes * EVAL_BATCHES, (
        eval_counts, stripes)
    assert all(np.isfinite(v) for v in ppl.values()), ppl
    log("perplexity " + json.dumps(dict(ppl, eval_batches=EVAL_BATCHES,
                                        batch=TRAIN_B, seq_len=TRAIN_S,
                                        eval_launches=eval_counts)))
    eng = ServingEngine(model, dcfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, act_dtype="int8",
                        device="cuda")
    res = drive(eng, prompts, dm, api, dcfg, "quantize_serve")
    del eng
    def spec_engine():
        return ServingEngine(model, dcfg, n_slots=4, max_len=256,
                             dtype=torch.bfloat16, act_dtype="int8",
                             draft_params=draft, spec=SpecConfig(gamma=GAMMA),
                             device="cuda")
    spec = drive(spec_engine(), prompts, dm, api, dcfg,
                 "quantize_spec_serve")
    limit, diff, windows = near_tie_limit(api, spec_engine(), prompts,
                                          "int8", spec)
    div = near_ties(spec["tokens"], res, limit, "quantize_spec_serve")
    spec.update(verify_vs_decode_max_abs=diff, near_tie_limit=limit,
                verify_windows_measured=windows,
                divergences=len(div), divergence_records=div,
                draft_effective_bits=drep.mean_effective_bits)
    res.update(depth=QUANT_DEPTH, calibrate_s=calib_s, quantize_s=quant_s,
               quantize_s_per_layer=quant_s / QUANT_DEPTH,
               draft_s=sum(map(sum, seconds["draft"].values())),
               target_s=sum(map(sum, seconds["target"].values())),
               seconds_per_matrix={part: {k: float(np.mean(v))
                                          for k, v in d.items()}
                                   for part, d in seconds.items()},
               mean_effective_bits=report.mean_effective_bits,
               draft_mean_effective_bits=drep.mean_effective_bits,
               total_proxy_loss=report.total_proxy_loss,
               card_vs_cpu=checks, spec=spec, perplexity=ppl,
               eval_counts=eval_counts, eval_m=[TRAIN_B * TRAIN_S])
    log("quantize " + json.dumps({k: res[k] for k in (
        "depth", "calibrate_s", "quantize_s", "quantize_s_per_layer",
        "draft_s", "target_s", "seconds_per_matrix", "mean_effective_bits",
        "draft_mean_effective_bits", "total_proxy_loss")}))
    log("quantize_spec_serve " + json.dumps(dict(
        acceptance_rate=spec["acceptance_rate"], windows=spec["engine_steps"],
        tokens_per_window=spec["tokens_per_step"],
        verify_vs_decode_max_abs=diff, divergences=div,
        ms_per_emitted_token=spec["decode_ms_per_token"],
        vanilla_ms_per_token=res["decode_ms_per_token"])))
    return res


# ------------------------------------------------------------ phase 10

@torch.no_grad()
def perplexity(api, cfg, model, batches):
    """exp of the mean next-token NLL of ``model`` over ``batches``."""
    nll = [float(api.loss_fn(model, cfg, {"tokens": b.cuda()})[1]["nll"])
           for b in batches]
    return float(np.exp(np.mean(nll)))


def phase_train(api, cfg):
    """10. Train llama1_7b at full width, cut in depth to ``QUANT_DEPTH``
    layers, for ``TRAIN_STEPS`` steps of ``make_train_step`` on the
    synthetic corpus (B ``TRAIN_B``, S ``TRAIN_S``; step ``MICRO_STEP`` in
    two microbatches), with deterministic algorithms on; the loss must
    fall.  After step ``CKPT_STEP`` the state is saved asynchronously while
    the next steps run; it is restored into a fresh model and optimizer
    state (bitwise the saved state) and trained on to the end, where each
    loss must equal the straight run's.  Returns the record and the
    trained model."""
    import shutil
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step

    dcfg = dataclasses.replace(cfg, n_layers=QUANT_DEPTH)
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    data = SyntheticCorpus(DataConfig(vocab=dcfg.vocab, seq_len=TRAIN_S,
                                      batch=TRAIN_B, seed=SEED))
    t0 = time.perf_counter()
    batches = [data.batch_at(s) for s in range(TRAIN_STEPS)]
    data_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    step_fns = {n: make_train_step(dcfg, ocfg, n) for n in (1, 2)}

    def fresh(seed):
        model = api.init_params(torch.Generator(device="cuda").manual_seed(
            seed), dcfg, "cuda")
        return model, init_opt_state(convert.param_tree(model, dcfg), ocfg)

    def state(model, opt):
        return {"params": convert.param_tree(model, dcfg), "opt": opt}

    ckpt_dir = REPO / "build" / "phase10_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    saved = {}

    def run(model, opt, lo, hi, straight):
        losses, step_ms, prof, prof_ms = [], {}, None, None
        for s in range(lo, hi):
            if straight and s == PROFILE_TRAIN_STEP:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                t_prof = time.perf_counter()
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt, met = step_fns[2 if s == MICRO_STEP else 1](
                model, opt, {"tokens": batches[s]})
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            step_ms[s] = (time.perf_counter() - t) * 1e3
            if prof is not None and prof_ms is None \
                    and s == PROFILE_TRAIN_STEP + 1:
                prof_ms = (time.perf_counter() - t_prof) * 1e3
                prof.stop()
            if not straight:
                continue
            if s + 1 == CKPT_STEP:
                st = state(model, opt)
                # on the host: a copy on the card would count in the peak
                saved["tensors"] = [t.detach().to("cpu", copy=True)
                                    for t in tree_lib.tensors(st)]
                t = time.perf_counter()
                mgr.save(CKPT_STEP, st, blocking=False)
                saved["t0"] = t
                saved["call_s"] = time.perf_counter() - t
            elif "t0" in saved and "write_s" not in saved:
                saved["overlapped_steps"] = s + 1 - CKPT_STEP
                if not mgr.pending():
                    saved["write_s"] = time.perf_counter() - saved["t0"]
        return model, opt, losses, step_ms, (prof, prof_ms)

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model, opt = fresh(SEED + 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        model, opt, losses, step_ms, (prof, prof_ms) = run(
            model, opt, 0, TRAIN_STEPS, straight=True)
        run_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated()
        mgr.wait()
        saved.setdefault("write_s", time.perf_counter() - saved["t0"])
        ckpt_bytes = sum(f.stat().st_size
                         for f in (ckpt_dir / f"step_{CKPT_STEP:010d}")
                         .iterdir())

        # preemption: the newest valid step, restored into a fresh model
        # and optimizer state
        fm, fo = fresh(SEED + 7)
        t = time.perf_counter()
        assert mgr.latest_step() == CKPT_STEP
        latest_s = time.perf_counter() - t
        t = time.perf_counter()
        st = mgr.restore(CKPT_STEP, state(fm, fo))
        tree_lib.copy_into(convert.param_tree(fm, dcfg), st["params"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        got = tree_lib.tensors(state(fm, st["opt"]))
        assert len(got) == len(saved["tensors"])
        assert all(a.dtype == b.dtype and torch.equal(a, b.cpu())
                   for a, b in zip(saved["tensors"], got)), \
            "the restored state is not the saved one"
        assert int(st["opt"].step) == CKPT_STEP
        del saved["tensors"], fo
        _, _, resumed, _, _ = run(fm, st["opt"], CKPT_STEP, TRAIN_STEPS,
                                  straight=False)
        del fm, st
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    gaps = [abs(a - b) for a, b in zip(resumed, losses[CKPT_STEP:])]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert max(gaps) == 0.0, ("the resumed run left the straight one",
                              gaps)

    n_params = sum(t.numel() for t in tree_lib.tensors(
        convert.param_tree(model, dcfg)))
    plain = [v for s, v in step_ms.items() if s not in (
        0, MICRO_STEP, PROFILE_TRAIN_STEP, PROFILE_TRAIN_STEP + 1)]
    res = dict(depth=QUANT_DEPTH, params=n_params, batch=TRAIN_B,
               seq_len=TRAIN_S, steps=TRAIN_STEPS, lr=TRAIN_LR,
               losses=losses, resumed_losses=resumed, resume_loss_gaps=gaps,
               ms_per_step=float(np.mean(plain)),
               ms_per_step_min=float(np.min(plain)),
               first_step_ms=step_ms[0],
               microbatch_step_ms=step_ms[MICRO_STEP],
               tokens_per_s=TRAIN_B * TRAIN_S / (np.mean(plain) / 1e3),
               data_ms_per_batch=data_ms, run_s=run_s,
               max_memory_allocated_gb=peak / 1e9,
               checkpoint_bytes=ckpt_bytes,
               checkpoint_save_call_s=saved["call_s"],
               checkpoint_write_s=saved["write_s"],
               checkpoint_overlapped_steps=saved.get("overlapped_steps", 0),
               latest_step_s=latest_s, restore_s=restore_s,
               restore_bitwise=True,
               profile_two_train_steps=device_profile(prof, prof_ms / 1e3))
    log("train " + json.dumps(res))
    return res, model


def check_plans(dm, ops, model, ms, gen):
    """K1 against its plain version, launch by launch, on every distinct
    prepared plan of ``model`` at each M of ``ms``: f32 x read raw
    (gather "kernel") and pre-gathered (blocked).  Returns the number of
    launches checked and the largest error."""
    plans = {}
    for m in quantized_modules(model):
        k = m.kernel
        plans.setdefault((k.rows, k.cols, tuple(g.bits for g in k.groups)),
                         k)
    n, err = 0, 0.0
    for pqt in plans.values():
        for M in ms:
            x = torch.randn((M, pqt.cols), generator=gen, device="cuda")
            for gather in ("kernel", "xla"):
                acc = None
                for xg, kw in ops.group_calls(x, pqt, gather):
                    yk = dm.dequant_matmul(xg, acc=acc,
                                           compute_dtype=torch.float32, **kw)
                    yp = dm.dequant_matmul_plain(
                        xg, acc=acc, compute_dtype=torch.float32, **kw)
                    diff = (yk - yp).abs()
                    assert torch.isfinite(yk).all()
                    assert not (diff > ATOL + RTOL * yp.abs()).any(), (
                        pqt.rows, pqt.cols, M, gather, float(diff.max()))
                    err = max(err, float(diff.max()))
                    acc = yk
                    n += 1
    return n, err


def phase_substrate(api, dm, ops, ServingEngine, SpecConfig, gen):
    """10b. The reference benchmarks' trained substrate on the card: the
    smoke llama1_7b widened as ``benchmarks/common.trained_model`` does it
    (vocab 512, 4 layers, d_model 160, 4 heads of 40, d_ff 448, f32),
    trained 200 steps (lr 6e-3, warmup 10, cosine to 220; B 16, S 64),
    calibrated on 16 segments; the paper's orderings of
    ``tests/test_pipeline_e2e.py`` asserted on the card's perplexities (4
    eval batches); then the AP+OR target served with its 2-bit draft at
    gamma ``GAMMA`` on 8 prompts, tokens held to vanilla's under the
    near-tie rule, and every plan it served held to the plain K1."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import APConfig, CLAQConfig, ORConfig, draft_config
    from repro_torch.data import DataConfig, SyntheticCorpus, calibration_set
    from repro_torch.launch.quantize import calibrate, quantize_model_params
    from repro_torch.optim import OptimConfig, init_opt_state
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        get_smoke_config("llama1_7b"), vocab=512, n_layers=4, d_model=160,
        n_heads=4, n_kv_heads=4, head_dim=40, d_ff=448)
    assert cfg.dtype == "float32"
    model = api.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                            cfg, "cuda")
    ocfg = OptimConfig(lr=6e-3, warmup_steps=10, total_steps=220)
    opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
    n_params = sum(t.numel() for t in tree_lib.tensors(
        convert.param_tree(model, cfg)))
    data = SyntheticCorpus(DataConfig(vocab=512, seq_len=64, batch=16,
                                      seed=0, name="c4like"))
    step = make_train_step(cfg, ocfg)
    t0 = time.perf_counter()
    losses = []
    for s in range(200):
        model, opt, met = step(model, opt, {"tokens": data.batch_at(s)})
        if s in (0, 199):
            losses.append(float(met["loss"]))
    train_s = time.perf_counter() - t0
    del opt
    hess = calibrate(model, cfg, calibration_set(512, 16, 64,
                                                 name="c4like"))
    evals = [SyntheticCorpus(DataConfig(512, 64, 16, seed=123)).batch_at(
        10_000 + i) for i in range(4)]

    reset_counts(dm)
    ppl = {"fp": perplexity(api, cfg, model, evals)}
    fusion = CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                        gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                        orr=ORConfig(0.1))
    recipes = {"claq3": CLAQConfig(bits=3, method="kmeans", kmeans_iters=6,
                                   gptq_blocksize=32),
               "gptq3": CLAQConfig(bits=3, method="uniform",
                                   gptq_blocksize=32),
               "claq2": CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                                   gptq_blocksize=32),
               "fusion": fusion}
    reps, t0 = {}, time.perf_counter()
    for tag, qcfg in recipes.items():
        qm, reps[tag] = quantize_model_params(copy.deepcopy(model), cfg,
                                              hess, qcfg)
        ppl[tag] = perplexity(api, cfg, qm, evals)
        if tag == "fusion":
            target = qm           # the AP+OR model served below
    quant_s = time.perf_counter() - t0
    eval_counts = read_counts(dm)
    # Table 1 trend: fp <= CLAQ <= GPTQ at 3 bits; fusion beats pure
    # 2-bit on the objective, perplexity within a no-regression band
    assert ppl["fp"] <= ppl["claq3"] * 1.001, ppl
    assert ppl["claq3"] <= ppl["gptq3"] * 1.05, ppl
    assert reps["fusion"].total_proxy_loss < reps["claq2"].total_proxy_loss
    assert ppl["fusion"] < ppl["claq2"] * 1.01, ppl
    assert 2.0 < reps["fusion"].mean_effective_bits < 2.6
    assert eval_counts["launches"] > 0

    draft, drep = quantize_model_params(copy.deepcopy(model), cfg, hess,
                                        draft_config(fusion, 2))
    del model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(3, 14)).tolist()
               for _ in range(8)]
    kw = dict(n_slots=4, max_len=64, min_bucket=8, dtype=torch.float32,
              device="cuda")
    base = drive(ServingEngine(target, cfg, **kw), prompts, dm, api, cfg,
                 "substrate_serve", prefill_rows=True)
    def spec_engine():
        return ServingEngine(target, cfg, draft_params=draft,
                             spec=SpecConfig(gamma=GAMMA), **kw)
    spec = drive(spec_engine(), prompts, dm, api, cfg, "substrate_spec_serve")
    limit, diff, windows = near_tie_limit(api, spec_engine(), prompts, None,
                                          spec)
    div = near_ties(spec["tokens"], base, limit, "substrate_spec_serve")
    ms = sorted(set(base["kernel_m"]) | set(spec["kernel_m"]) | {16 * 64})
    n_checked, err = check_plans(dm, ops, target, ms, gen)
    n_draft, err_d = check_plans(dm, ops, draft, ms, gen)
    res = dict(params=n_params, train_s=train_s, first_loss=losses[0],
               last_loss=losses[1],
               perplexity=ppl, quantize_s=quant_s,
               effective_bits={k: r.mean_effective_bits
                               for k, r in reps.items()},
               proxy_loss={k: r.total_proxy_loss for k, r in reps.items()},
               draft_effective_bits=drep.mean_effective_bits,
               eval_launches=eval_counts["launches"],
               vanilla_ms_per_token=base["decode_ms_per_token"],
               spec_ms_per_token=spec["decode_ms_per_token"],
               acceptance_rate=spec["acceptance_rate"],
               tokens_per_window=spec["tokens_per_step"],
               windows=spec["engine_steps"],
               verify_vs_decode_max_abs=diff, near_tie_limit=limit,
               verify_windows_measured=windows,
               divergences=len(div), divergence_records=div,
               kernel_m=ms, plan_launches_checked=n_checked + n_draft,
               plan_max_abs_err=max(err, err_d),
               phase_s=time.perf_counter() - t_phase)
    res["launches"] = dict(
        quantized_eval=eval_counts,
        serve=dict(launches=base["main_path_launches"],
                   aligned=base["main_path_aligned_launches"],
                   gathered=base["main_path_gathered_launches"]),
        spec_serve=dict(launches=spec["main_path_launches"],
                        aligned=spec["main_path_aligned_launches"],
                        gathered=spec["main_path_gathered_launches"]))
    log("substrate " + json.dumps(res))
    return res


# ------------------------------------------------------------ phase 11

class KernelShapes:
    """While open, record the M of every prepared matmul by ``key(plan)``
    (default its (out, in) shape; a plan whose key is None is skipped):
    the (shape, M) pairs a run gave K1."""

    def __init__(self, ops, key=lambda pqt: tuple(pqt.shape)):
        self.ops, self.inner, self.seen = ops, ops.prepared_qmatmul, {}
        self.key = key

    def __enter__(self):
        def recorded(x, pqt, **kw):
            k = self.key(pqt)
            if k is not None:
                self.seen.setdefault(k, set()).add(
                    int(np.prod(x.shape[:-1])))
            return self.inner(x, pqt, **kw)
        self.ops.prepared_qmatmul = recorded
        return self

    def __exit__(self, *exc):
        self.ops.prepared_qmatmul = self.inner


class MoeDrops:
    """While open, keep every ``moe_mlp`` call's token count and capacity
    drops (device counts, read once at the end)."""

    def __init__(self, moe_lib):
        self.lib, self.inner, self.calls = moe_lib, moe_lib.moe_mlp, []

    def __enter__(self):
        def counted(p, x, cfg, stats=None, **kw):
            st = {}
            out = self.inner(p, x, cfg, st, **kw)
            self.calls.append((x.shape[1] == 1, x.shape[0] * x.shape[1],
                               st["dropped"]))
            return out
        self.lib.moe_mlp = counted
        return self

    def __exit__(self, *exc):
        self.lib.moe_mlp = self.inner

    def summary(self, cfg):
        out = {}
        for kind, decode in (("decode", True), ("prefill", False)):
            calls = [(t, int(d)) for dec, t, d in self.calls if dec == decode]
            layers = max(cfg.n_layers, 1)
            out[kind] = dict(
                calls=len(calls), steps=len(calls) // layers,
                assignments=sum(t for t, _ in calls) * cfg.top_k,
                dropped=sum(d for _, d in calls),
                dropped_per_step=(sum(d for _, d in calls)
                                  / max(len(calls) // layers, 1)))
        return out


def expert_split_ms(moe_lib, model, cfg, flush, reps=5):
    """Device ms of one decode step's expert work (4 slots: cap 1), per
    layer and over every layer: the three stacks' dequantize against the
    three expert einsums (CUDA events, after an L2 flush)."""
    mlp = model.blocks[0].mlp
    E, D = cfg.n_experts, cfg.d_model
    cap = moe_lib.capacity(4, cfg)
    xd = torch.randn((1, E, cap, D), device="cuda").to(torch.bfloat16)
    ws = [moe_lib.expert_weight(getattr(mlp, n), torch.bfloat16)
          for n in ("w_gate", "w_up", "w_down")]

    def deq():
        for n in ("w_gate", "w_up", "w_down"):
            moe_lib.expert_weight(getattr(mlp, n), torch.bfloat16)

    def ein():
        h = torch.einsum("gecd,edf->gecf", xd, ws[0])
        h = torch.nn.functional.silu(h) * torch.einsum("gecd,edf->gecf", xd,
                                                       ws[1])
        torch.einsum("gecf,efd->gecd", h, ws[2])
    torch.cuda.synchronize()
    d, e = time_ms(deq, reps, flush), time_ms(ein, reps, flush)
    return dict(cap=cap, dequantize_ms_per_layer=d, einsum_ms_per_layer=e,
                dequantize_ms_per_step=d * cfg.n_layers,
                einsum_ms_per_step=e * cfg.n_layers)


def phase_family(api, dm, ops, ServingEngine, cfg, prompts, gen, host_gen,
                 tag, ways):
    """Phases 11/11b: a moe config at full width with synthetic CLAQ AP+OR
    weights (the expert stacks included) through ``ServingEngine`` with 4
    slots, one ``drive`` per cache layout in ``ways``: batch-1, unpadded
    prefills only; the (shape, M) pairs K1 ran; capacity drops; the
    expert dequantize against the expert einsums; an untimed second serve
    of the first layout gives its tokens again.  Returns (records by
    layout, one served plan per K1 shape, the (shape, M) pairs)."""
    from repro_torch.models import moe as moe_lib
    t0 = time.perf_counter()
    model = synthetic_model(cfg, gen, host_gen, "cuda")
    torch.cuda.synchronize()
    qmods = quantized_modules(model)
    stacks = [m for m in qmods if m.kernel.stack]
    assert len(stacks) == 3 * cfg.n_layers, len(stacks)
    packed = sum(s.packed.numel() * 4 for m in qmods for s in m.kernel.stripes)
    log(f"{tag}: built {len(qmods) - len(stacks)} CLAQ matrices and "
        f"{len(stacks)} stacks of {cfg.n_experts} experts in "
        f"{time.perf_counter() - t0:.1f} s: packed codes {packed / 1e9:.3f} "
        f"GB, mean effective bits "
        f"{np.mean([m.kernel.effective_bits() for m in qmods]):.3f}")
    out, shapes = {}, {}
    for way, kw in ways:
        eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                            dtype=torch.bfloat16, device="cuda", **kw)
        assert not eng.bucketing.enabled and not eng._preemptible
        with KernelShapes(ops) as seen, MoeDrops(moe_lib) as drops:
            res = drive(eng, prompts, dm, api, cfg, f"{tag}_{way}")
        per_shape = eng.bucketing.stats.per_shape
        assert all(b == 1 for b, _ in per_shape), per_shape
        assert sorted(n for _, n in per_shape) == sorted(
            set(len(p) for p in prompts)), per_shape
        for k, v in seen.seen.items():
            shapes.setdefault(k, set()).update(v)
        res.update(capacity_drops=drops.summary(cfg),
                   k1_shapes={f"{r}x{c}": sorted(v)
                              for (r, c), v in sorted(seen.seen.items())})
        log(f"{tag}_{way} extra " + json.dumps({k: res[k] for k in (
            "capacity_drops", "k1_shapes")}))
        out[way] = res
        del eng
    first = ways[0][0]
    out[first]["contracts"] = contract_gate(ServingEngine, cfg, model, tag,
                                            **ways[0][1])
    again = small_serve(ServingEngine(model, cfg, n_slots=4, max_len=256,
                                      dtype=torch.bfloat16, device="cuda",
                                      **ways[0][1]), prompts, MAX_NEW)
    assert again == out[first]["tokens"], "a second serve left the first"
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    split = expert_split_ms(moe_lib, model, cfg, flush)
    log(f"{tag} expert work per decode step " + json.dumps(split))
    out[first]["expert_split"] = split
    served = {}
    served_plans(model, served)
    assert set(shapes) <= set(served), (sorted(shapes), sorted(served))
    del model
    torch.cuda.empty_cache()
    return out, served, shapes


def phase_deepseek(api, dm, ops, ServingEngine, cfg, prompts, gen, host_gen):
    """11b: deepseek_v2_236b at full width, 1 layer, served contiguous,
    paged fp (exactly the contiguous tokens) and paged int8 (budgets,
    bytes a page); chunked prefill refused (family moe); the latent cache
    bytes a token against a full K/V cache's."""
    ways = (("contiguous", {}),
            ("paged", dict(kv_layout="paged", page_size=PAGE_SIZE)),
            ("paged_int8", dict(kv_layout="paged", page_size=PAGE_SIZE,
                                kv_dtype="int8")))
    out, served, shapes = phase_family(api, dm, ops, ServingEngine, cfg,
                                       prompts, gen, host_gen, "deepseek",
                                       ways)
    assert out["paged"]["tokens"] == out["contiguous"]["tokens"]
    pg8 = out["paged_int8"]["paged"]
    assert pg8["peak_pages_in_use"] <= pg8["n_pages"]
    assert pg8["bytes_per_page"] < out["paged"]["paged"]["bytes_per_page"]
    try:          # refused before the engine touches any weight
        ServingEngine(None, cfg, chunked_prefill=CHUNK_TOKENS, n_slots=4,
                      max_len=256, device="cuda")
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("chunked prefill was not refused for moe")
    lat = cfg.n_layers * (cfg.kv_lora + cfg.rope_head_dim) * 2
    full = cfg.n_layers * cfg.n_heads * (
        cfg.head_dim + cfg.rope_head_dim + cfg.v_head_dim) * 2
    cache = dict(latent_bytes_per_token=lat, full_kv_bytes_per_token=full,
                 ratio=full / lat, chunked_refused=refused,
                 int8_bytes_per_page=pg8["bytes_per_page"],
                 fp_bytes_per_page=out["paged"]["paged"]["bytes_per_page"])
    log("deepseek cache " + json.dumps(cache))
    out["contiguous"]["cache"] = cache
    return out, served, shapes


def phase_new_shapes(dm, ops, served, shapes, gen, act):
    """K1 (act "f32") or K1e ("int8") against its plain version on each
    served bf16 plan (``served[key]``: a whole plan, or a shard-local one)
    at every M of ``shapes[key]`` (gathered: AP columns are permuted),
    each launch on the same inputs; device ms from a CUDA graph beside
    ``torch.matmul`` on the dequantized weight and the bound.  Returns the
    records and the largest error."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    cases, max_err = [], 0.0
    for key in sorted(shapes):
        pqt = served[key]
        rows, cols = pqt.shape
        w = pqt.dequantize(torch.bfloat16)
        for m in sorted(shapes[key]):
            x = torch.randn((m, cols), generator=gen,
                            device="cuda").to(torch.bfloat16)
            xk, scale = (ops.quantize_activations(x) if act == "int8"
                         else (x, None))
            calls = list(ops.group_calls(xk, pqt, "kernel", x_scale=scale))
            acc, err = None, 0.0
            for xg, kw in calls:
                yk = dm.dequant_matmul(xg, acc=acc,
                                       compute_dtype=torch.bfloat16, **kw)
                yp = dm.dequant_matmul_plain(xg, acc=acc,
                                             compute_dtype=torch.bfloat16,
                                             **kw)
                torch.cuda.synchronize()
                diff = (yk - yp).abs()
                assert torch.isfinite(yk).all()
                assert not (diff > ATOL + RTOL * yp.abs()).any(), (
                    rows, cols, m, act, float(diff.max()))
                err = max(err, float(diff.max()))
                acc = yk

            def run(calls=calls):
                y = None
                for xg, kw in calls:
                    y = dm.dequant_matmul(xg, acc=y,
                                          compute_dtype=torch.bfloat16, **kw)
                return y
            nb, fl = chain_bytes_flops(pqt, m, xk.element_size())
            if scale is not None:
                nb += scale.numel() * scale.element_size()
            bound_ms, by = bound_of(nb, fl, torch.bfloat16)
            rec = dict(shape=f"{rows}x{cols}", m=m, act=act,
                       block=(None if pqt.shard is None else
                              f"{pqt.shard.index} of {pqt.shard.parts} "
                              f"({pqt.shard.rows} rows)"),
                       launches=len(calls), max_abs_err=err,
                       device_ms=graph_ms(run, 5, flush),
                       library_device_ms=graph_ms(
                           lambda x=x: torch.matmul(x, w.T), 5, flush),
                       bound_ms=bound_ms, bound_by=by)
            max_err = max(max_err, err)
            cases.append(rec)
            log("kernel_new_shape " + json.dumps(rec))
        del w
    torch.cuda.empty_cache()
    return cases, max_err


# ------------------------------------------------------- phases 12-12c

def batch_noise(a, b):
    """Largest |a - b| over the decode logits rows two ``drive`` records
    share (same request, same position, same tokens before it): the
    batched serve against its batch-1 runs."""
    gap = 0.0
    for ta, tb, ra, rb in zip(a["tokens"], b["tokens"], a["decode_logits"],
                              b["decode_logits"]):
        for j in sorted(set(ra) & set(rb)):
            if ta[:j] != tb[:j]:
                break
            gap = max(gap, float((ra[j] - rb[j]).abs().max()))
    return gap


def sub_record(rec, idx):
    """The tokens and logits rows of ``rec`` (a ``drive`` record) for the
    requests ``idx``, as ``near_ties`` reads them."""
    return {k: [rec[k][i] for i in idx]
            for k in ("tokens", "decode_logits", "prefill_logits")
            if k in rec}


def served_plans(model, into):
    """One served plan per (out, in) shape of ``model`` into ``into``."""
    for m in quantized_modules(model):
        if not m.kernel.stack:
            into.setdefault(tuple(m.kernel.shape), m.kernel)


def phase_recurrent(api, dm, ops, ServingEngine, cfg, prompts, gen,
                    host_gen, tag):
    """Phases 12 and 12b(a): a recurrent config at full width with
    synthetic CLAQ AP+OR weights through ``ServingEngine`` (4 slots,
    ``max_len`` 256): unpadded prefills (equal lengths only batch), the
    launch counts, a profile of two decode steps; the same prompts at
    batch 1 (``n_slots`` 1), whose tokens are held to the batched ones
    under the near-tie rule with a limit of twice the largest |batched -
    batch-1| decode logit difference; then one preemption (a
    higher-priority fifth request into 4 busy slots) and its resume, the
    resumed tokens held the same way.  Returns (record, model, the
    (shape, M) pairs K1 ran)."""
    t0 = time.perf_counter()
    model = synthetic_model(cfg, gen, host_gen, "cuda")
    torch.cuda.synchronize()
    qmods = quantized_modules(model)
    packed = sum(s.packed.numel() * 4 for m in qmods for s in m.kernel.stripes)
    build_s = time.perf_counter() - t0
    log(f"{tag}: built {len(qmods)} CLAQ matrices in {build_s:.1f} s: packed "
        f"codes {packed / 1e9:.3f} GB, mean effective bits "
        f"{np.mean([m.kernel.effective_bits() for m in qmods]):.3f}")
    kw = dict(max_len=256, dtype=torch.bfloat16, device="cuda")
    shapes = {}
    eng = ServingEngine(model, cfg, n_slots=4, **kw)
    assert not eng.bucketing.enabled and eng._preemptible
    with KernelShapes(ops) as seen:
        res = drive(eng, prompts, dm, api, cfg, tag, prefill_rows=True)
        one = drive(ServingEngine(model, cfg, n_slots=1, **kw), prompts, dm,
                    api, cfg, f"{tag}_batch1", one_by_one=True)
    noise = batch_noise(res, one)
    limit = 2 * noise
    div = near_ties(one["tokens"], res, limit, f"{tag}_batch1")
    # preemption: 4 requests fill the slots, a higher-priority fifth
    # preempts the youngest, which resumes when a slot frees
    eng = ServingEngine(model, cfg, n_slots=4, **kw)
    reset_counts(dm)
    t0 = time.perf_counter()
    with KernelShapes(ops) as seen_p:
        uids = eng.add_requests(prompts[:4], max_new_tokens=MAX_NEW)
        eng.step()
        eng.step()
        uids.append(eng.submit(prompts[4], max_new_tokens=MAX_NEW,
                               priority=5))
        eng.run_to_completion()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    counts = read_counts(dm)
    fin = eng.take_finished()
    st = eng.stats()
    assert st["preemptions"] == 1 and st["resumes"] == 1, st
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == MAX_NEW for u in uids)
    div_p = near_ties([fin[u].tokens for u in uids],
                      sub_record(res, range(5)), limit, f"{tag}_preempt")
    for rec in (seen.seen, seen_p.seen):
        for k, v in rec.items():
            shapes.setdefault(k, set()).update(v)
    res.update(
        build_s=build_s, packed_gb=packed / 1e9,
        batch1_launches=one["main_path_launches"],
        batch1=dict(decode_ms_per_step=one["decode_ms_per_step"],
                    noise=noise, limit=limit, divergences=len(div),
                    divergence_records=div),
        preempt_resume=dict(preemptions=st["preemptions"],
                            resumes=st["resumes"], run_s=pre_s,
                            divergences=len(div_p),
                            kernel_m=sorted(engine_kernel_m(eng)), **counts),
        k1_shapes={f"{r}x{c}": sorted(v) for (r, c), v in
                   sorted(shapes.items())})
    log(f"{tag} extra " + json.dumps({k: res[k] for k in (
        "batch1", "preempt_resume", "k1_shapes")}, default=str))
    res["contracts"] = contract_gate(ServingEngine, cfg, model, tag)
    return res, model, shapes


class Widened:
    """While open, ``model``'s embedding and dense ``lm_head`` are f32, so
    the model runs f32 activations (K1 computing in f32): the setting of
    the tight chunked-vs-recurrent and cache-vs-forward checks, where
    bf16 rounding (the SSD rounds its operands to the activation dtype,
    as the reference does) would hide a fault."""

    def __init__(self, model):
        self.model = model
        self.emb, self.head = model.embedding, model.lm_head.kernel

    def __enter__(self):
        self.model.embedding = self.emb.float()
        self.model.lm_head.set_kernel(self.head.float())
        return self.model

    def __exit__(self, *exc):
        self.model.embedding = self.emb
        self.model.lm_head.set_kernel(self.head)


def f32_tol(scale):
    """The f32 checks' tolerance: 1e-3 of the logits' scale (at least 1),
    the reference's own chunked-vs-recurrent tolerance."""
    return 1e-3 * max(1.0, scale)


def phase_rwkv(api, dm, ops, ServingEngine, cfg, prompts, gen, host_gen):
    """12: rwkv6_7b at full width, ``RWKV_DEPTH`` layers (see
    ``phase_recurrent``); then, in f32 activations (the embedding and
    lm_head widened for the check, K1 computing in f32), the chunked
    prefill of a ``RWKV_CHECK_LEN``-token prompt against as many
    recurrent decode steps: last-position logits within 1e-3 of the
    logits' scale (the reference's own chunked-vs-recurrent WKV
    tolerance)."""
    res, model, shapes = phase_recurrent(api, dm, ops, ServingEngine, cfg,
                                         prompts, gen, host_gen, "rwkv")
    toks = torch.randint(1, cfg.vocab, (1, RWKV_CHECK_LEN),
                         generator=host_gen).cuda()
    with Widened(model), torch.no_grad():
        lp, _ = api.prefill_step(model, cfg, {"tokens": toks},
                                 api.make_cache(cfg, 1, 128, torch.float32,
                                                "cuda"))
        c = api.make_cache(cfg, 1, 128, torch.float32, "cuda")
        for t in range(RWKV_CHECK_LEN):
            ld, c = api.decode_step(model, cfg, toks[:, t], c)
    scale = float(lp.abs().max())
    gap = float((lp - ld).abs().max())
    assert torch.isfinite(lp).all() and gap <= f32_tol(scale), (gap, scale)
    res["chunked_vs_recurrent"] = dict(tokens=RWKV_CHECK_LEN, max_abs=gap,
                                       logit_scale=scale,
                                       same_argmax=bool(lp.argmax()
                                                        == ld.argmax()))
    log("rwkv chunked_vs_recurrent " + json.dumps(
        res["chunked_vs_recurrent"]))
    served = {}
    served_plans(model, served)
    del model
    torch.cuda.empty_cache()
    return res, served, shapes


def logits_vs_forward(rows, fwd, tokens, tag):
    """Decode logits ``rows`` (position -> the row a token was emitted
    from; f32 activations) against a cacheless forward's rows ``fwd`` at
    the same positions: max |diff| within ``f32_tol`` of the forward's
    largest logit, and greedy tokens equal except at a near tie (the
    forward's top-2 gap, and the emitted token's deficit, below twice
    that max |diff|)."""
    diff = max(float((rows[j] - fwd[j]).abs().max()) for j in rows)
    scale = max(float(fwd[j].abs().max()) for j in rows)
    assert diff <= f32_tol(scale), (tag, diff, scale)
    ties = []
    for j in sorted(rows):
        if int(fwd[j].argmax()) != tokens[j]:
            top2 = torch.topk(fwd[j], 2).values
            ties.append(dict(position=j, gap=float(top2[0] - top2[1]),
                             deficit=float(top2[0] - fwd[j][tokens[j]])))
    assert all(t["gap"] < 2 * diff and t["deficit"] < 2 * diff
               for t in ties), (tag, ties, diff)
    return dict(max_abs=diff, logit_scale=scale, rel=diff / scale,
                near_ties=ties)


def phase_ring(api, dm, ops, ServingEngine, cfg, model, host_gen):
    """12b(b): one ``RING_PROMPT``-token request at ``max_len``
    ``RING_MAX_LEN`` (ring caches of ``attn_window`` rows): the prefill
    rolls the last W keys into the ring, and ``RING_DECODE`` decode steps
    each overwrite its oldest slot.  The emitted tokens' logits against a
    cacheless windowed forward over the whole sequence
    (``logits_vs_forward``); the model ``Widened`` to f32 activations and
    an f32 cache, where a wrong ring slot would show."""
    with Widened(model):
        return _ring(api, dm, ops, ServingEngine, cfg, model, host_gen)


def _ring(api, dm, ops, ServingEngine, cfg, model, host_gen):
    eng = ServingEngine(model, cfg, n_slots=1, max_len=RING_MAX_LEN,
                        dtype=torch.float32, device="cuda")
    W = eng.cache[-1].k.shape[1]
    assert W == cfg.attn_window < RING_PROMPT, W
    prompt = torch.randint(1, cfg.vocab, (RING_PROMPT,),
                           generator=host_gen).tolist()
    rec = DecodeLogits(api, True)
    rows = {}
    reset_counts(dm)
    with KernelShapes(ops) as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uid = eng.add_requests([prompt], max_new_tokens=RING_DECODE + 1)[0]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        decode_s = []
        while eng.active:
            at = {u: (r.slot, len(r.tokens)) for u, r in eng.active.items()}
            t0 = time.perf_counter()
            with rec:
                emitted = eng.step()
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            rec.file(rows, at, emitted)
    counts = read_counts(dm)
    req = eng.take_finished()[uid]
    assert req.state.value == "finished" and len(rows[uid]) == RING_DECODE
    length = int(eng.cache[-1].length[0])
    assert length == RING_PROMPT + RING_DECODE, length
    seq = torch.tensor([prompt + req.tokens[:-1]], device="cuda")
    with torch.no_grad():
        fwd, _, _ = api.tf.forward(model, cfg, seq)
    fwd = {j: fwd[0, RING_PROMPT - 1 + j].float() for j in rows[uid]}
    check = logits_vs_forward(rows[uid], fwd, req.tokens, "ring")
    res = dict(prompt=RING_PROMPT, window=W, decode_steps=len(decode_s),
               prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=float(np.mean(decode_s)) * 1e3,
               vs_forward=check, **counts)
    log("zamba2_ring " + json.dumps(res))
    return res, seen.seen


def phase_zamba2(api, dm, ops, ServingEngine, cfg, prompts, gen, host_gen):
    """12b: zamba2_1p2b at full width and depth: (a) ``phase_recurrent``;
    (b) ``phase_ring``."""
    res, model, shapes = phase_recurrent(api, dm, ops, ServingEngine, cfg,
                                         prompts, gen, host_gen, "zamba2")
    ring, seen = phase_ring(api, dm, ops, ServingEngine, cfg, model,
                            host_gen)
    for k, v in seen.items():
        shapes.setdefault(k, set()).update(v)
    res["ring"] = ring
    served = {}
    served_plans(model, served)
    del model
    torch.cuda.empty_cache()
    return res, served, shapes


def _encdec_run(api, model, cfg, frames, toks):
    """``api.prefill_step`` over ``frames`` then ``MAX_NEW`` greedy
    ``api.decode_step``s: (rows: token j -> the logits it was emitted from
    (0: the prefill's), tokens (B, MAX_NEW + 1), prefill s, decode s a
    step)."""
    B, Ss = frames.shape[:2]
    cache = api.make_cache(cfg, B, toks.shape[1] + MAX_NEW,
                           model.embedding.dtype, "cuda", src_len=Ss)
    rows, out, decode_s = {}, [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = api.prefill_step(model, cfg, {"frames": frames,
                                                  "tokens": toks}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for j in range(MAX_NEW + 1):
            rows[j] = lg.float()
            out.append(lg.argmax(dim=-1))
            if j == MAX_NEW:
                break
            t0 = time.perf_counter()
            lg, cache = api.decode_step(model, cfg, out[-1], cache)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
    return rows, torch.stack(out, dim=1), prefill_s, decode_s


def phase_encdec(api, dm, ops, ServingEngine, cfg, gen, host_gen):
    """12c: seamless_m4t_medium at full width and depth with synthetic
    CLAQ AP+OR weights, prepared into plans, through ``api.prefill_step``
    over seeded frames and ``MAX_NEW`` ``api.decode_step``s (the engine
    refuses encdec, as the reference's does): launch counts, the (shape,
    M) pairs, prefill and decode ms, peak memory.  Then the same run
    ``Widened`` to f32 activations, its decode logits against a
    teacher-forced ``decode_blocks`` forward (``logits_vs_forward``)."""
    from repro_torch.kernels.plan import prepare_tree
    from repro_torch.models import encdec as ed
    from repro_torch.models import modules as M
    t0 = time.perf_counter()
    model = synthetic_model(cfg, gen, host_gen, "cuda")
    torch.cuda.synchronize()
    qmods = quantized_modules(model)
    log(f"encdec: built {len(qmods)} CLAQ matrices in "
        f"{time.perf_counter() - t0:.1f} s, mean effective bits "
        f"{np.mean([m.kernel.effective_bits() for m in qmods]):.3f}")
    model = prepare_tree(model)
    try:
        ServingEngine(model, cfg, n_slots=4, max_len=64, device="cuda")
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("the engine served encdec")
    B, Ss = ENCDEC_FRAMES
    frames = torch.randn((B, Ss, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(1, cfg.vocab, (B, ENCDEC_PROMPT),
                         generator=host_gen).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dm)
    with KernelShapes(ops) as seen:
        launches0 = dm.launch_count
        rows, gen_toks, prefill_s, decode_s = _encdec_run(api, model, cfg,
                                                          frames, toks)
    counts = read_counts(dm)
    peak = torch.cuda.max_memory_allocated()
    assert all(torch.isfinite(r).all() for r in rows.values())
    assert gen_toks.shape == (B, MAX_NEW + 1)
    # the check, in f32 activations
    with Widened(model), torch.no_grad():
        f = frames.float()
        rows32, toks32, _, _ = _encdec_run(api, model, cfg, f, toks)
        x, _, _ = ed.decode_blocks(
            model, cfg, M.embed(model.embedding, torch.cat(
                [toks, toks32[:, :-1]], dim=1)),
            enc_out=ed.encode(model, cfg, f))
        fwd = M.dense(model.lm_head, M.rms_norm(model.final_norm, x,
                                                cfg.norm_eps))
    checks = [logits_vs_forward(
        {j: rows32[j][b] for j in rows32},
        {j: fwd[b, ENCDEC_PROMPT - 1 + j].float() for j in rows32},
        toks32[b].tolist(), f"encdec row {b}") for b in range(B)]
    plan_all, _ = plan_launches(model)
    dec_skip = sum(len(b.cross.k.kernel.groups) + len(b.cross.v.kernel.groups)
                   for b in model.dec_blocks)
    enc_groups = sum(len(m.kernel.groups) for m in
                     quantized_modules(model.enc_blocks))
    per_step = plan_all - enc_groups - dec_skip
    assert counts["launches"] - launches0 == plan_all + MAX_NEW * per_step, (
        counts, plan_all, per_step)
    served, shapes = {}, dict(seen.seen)
    served_plans(model, served)
    res = dict(frames=[B, Ss], prompt=ENCDEC_PROMPT, decode_steps=MAX_NEW,
               prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=float(np.mean(decode_s)) * 1e3,
               launches_per_prefill=plan_all,
               launches_per_decode_step=per_step,
               max_memory_allocated_gb=peak / 1e9,
               f32_vs_forward=dict(
                   max_abs=max(c["max_abs"] for c in checks),
                   rel=max(c["rel"] for c in checks),
                   near_ties=sum(len(c["near_ties"]) for c in checks)),
               engine_refused=refused,
               k1_shapes={f"{r}x{c}": sorted(v) for (r, c), v in
                          sorted(shapes.items())}, **counts)
    log("encdec " + json.dumps(res))
    del model
    torch.cuda.empty_cache()
    return res, served, shapes


# ------------------------------------------------------------ phase 9

def contract_gate(ServingEngine, cfg, model, tag, **kw):
    """Phase 13 on one served model: ``ServingEngine(verify_contracts=True)``
    (4 slots, ``max_len`` 256, bf16) on the card.  The gate profiles one
    decode step of the engine and, when it holds plans, of its dense twin
    (the model over its dequantized weights); an ERROR finding raises
    ``ContractViolation`` here and ends the run.  Logs the report's rules
    and findings and the quantized step's transfers: exactly one ``Memcpy
    DtoH`` (``_sample``'s) is asserted.  Returns the record."""
    from repro_torch.analysis import artifacts
    from repro_torch.analysis import op_trace as OT
    traces = []
    real = artifacts.decode_ops

    def keep(engine):
        traces.append(real(engine))
        return traces[-1]

    artifacts.decode_ops = keep
    t0 = time.perf_counter()
    try:
        eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                            dtype=torch.bfloat16, device="cuda",
                            verify_contracts=True, **kw)
    finally:
        artifacts.decode_ops = real
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    rep = eng.contract_report
    step = traces[0]
    counts = OT.transfer_counts(step)
    rec = dict(rules_run=rep.rules_run, rules_skipped=rep.rules_skipped,
               findings=[(f.rule_id, f.severity.name, f.message)
                         for f in rep.findings],
               transfers=counts, k1=OT.k1_modes(step),
               moved_leaves=OT.moved_leaves(step),
               dense_twin=len(traces) == 2, gate_s=gate_s)
    log(f"contracts {tag}: " + json.dumps(rec))
    for line in rep.render().splitlines():
        log("  " + line)
    assert rep.clean and counts["to_host"] == 1 and counts["dtoh"] == 1, rec
    assert not OT.host_transfer_instructions(step), rec
    assert rec["dense_twin"] and "HLO-GA1" in rep.rules_run, rec
    # the trace holds every K1 launch of the step: none nested away
    assert sum(rec["k1"].values()) == plan_launches(eng.params,
                                                    decode=True)[0], rec
    del eng, traces
    torch.cuda.empty_cache()
    return rec


def contract_refusal(api, ServingEngine, cfg):
    """Phase 13's mutation on the card: a decode step whose trace holds a
    second ``Memcpy DtoH`` keeps ``ServingEngine(verify_contracts=True)``
    from coming up (``ContractViolation`` naming HLO-HT1), on the smoke
    ``cfg``."""
    from repro_torch.analysis import ContractViolation, artifacts
    from repro_torch.analysis import op_trace as OT
    model = api.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                            cfg, "cuda")
    dtoh = OT.OpRecord("Memcpy DtoH (Device -> Pageable)", "device")
    bad = OT.OpTrace([OT.OpRecord(OT.TO_HOST), dtoh, dtoh])
    real = artifacts.decode_ops
    artifacts.decode_ops = lambda engine: bad
    try:
        ServingEngine(model, cfg, n_slots=4, max_len=64, prepare=False,
                      device="cuda", verify_contracts=True)
    except ContractViolation as e:
        assert "HLO-HT1" in str(e), e
        log("contracts refusal: a step with two DtoH copies raised "
            "ContractViolation (HLO-HT1)")
    else:
        raise AssertionError("the engine came up over a violating step")
    finally:
        artifacts.decode_ops = real
    return True


def reset_counts(dm):
    dm.launch_count = dm.int8_launch_count = dm.plain_count = 0
    dm.aligned_launch_count = 0


def read_counts(dm):
    """The launch counts of the run since ``reset_counts``; the main path
    must not have run the plain version on the card."""
    assert dm.plain_count == 0, "the main path ran the plain version"
    return dict(launches=dm.launch_count, aligned=dm.aligned_launch_count,
                gathered=dm.launch_count - dm.aligned_launch_count,
                int8=dm.int8_launch_count)


def engine_kernel_m(eng):
    """Every M an engine's run gave K1: prefill Bb * bucket (resumes at
    Bb = 1), decode rows (n_slots; 1 in a resume's replay), chunks
    Bb * chunk_tokens, verify rows n_slots * (gamma_eff + 1)."""
    ms = {b * n for b, n in eng.bucketing.stats.per_shape}
    for kind in ("decode", "draft_decode"):
        ms |= {shape[0] for shape in eng.call_shapes[kind]}
    for kind in ("chunk_prefill", "draft_chunk_prefill", "verify"):
        ms |= {b * c for b, c in eng.call_shapes[kind]}
    return ms


def synced_timer(fn, spent):
    """``fn`` wrapped to append its synchronized wall time (s) to
    ``spent``."""
    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    return timed


def serve_queued(eng, prompts, api, submit_at=None, clock=None,
                 record=False, max_steps=600):
    """Submit prompt i at step ``submit_at[i]`` (default all at 0)
    through ``submit()`` and step (advancing ``clock``) until every
    request is terminal.  With ``record`` (a vanilla, unchunked engine)
    the decode logits each token was emitted from are kept, as ``drive``
    keeps them.  Returns tokens in prompt order, the requests, per-step
    wall times of steps that ran no prefill, and the rows."""
    submit_at = submit_at or [0] * len(prompts)
    rec = DecodeLogits(api, record)
    rows, uids, decode_s = {}, [None] * len(prompts), []
    for step in range(max_steps):
        for i, at_step in enumerate(submit_at):
            if at_step == step:
                uids[i] = eng.submit(prompts[i], max_new_tokens=MAX_NEW)
        if (None not in uids and not eng.active and not len(eng.queue)
                and not eng.pending_prefills):
            break
        if record:
            eng.pump()        # admit first, so the slots below are current
        at = {u: (r.slot, len(r.tokens)) for u, r in eng.active.items()}
        calls = sum(eng.bucketing.stats.per_shape.values())
        chunks = eng.chunks_processed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec:
            emitted = eng.step()
        torch.cuda.synchronize()
        if (emitted and calls == sum(eng.bucketing.stats.per_shape.values())
                and chunks == eng.chunks_processed):
            decode_s.append(time.perf_counter() - t0)
        rec.file(rows, at, emitted)
        if clock is not None:
            clock.advance(eng.last_step_cost_ms)
    else:
        raise AssertionError(f"not drained in {max_steps} steps")
    fin = eng.take_finished()
    reqs = [fin[u] for u in uids]
    return dict(tokens=[r.tokens for r in reqs], reqs=reqs,
                decode_s=decode_s,
                decode_logits=[rows.get(u, {}) for u in uids])


def phase_preempt_resume(api, dm, serve_mod, cfg, model, prompts, base,
                         limit):
    """9a: phase 4's prompts through ``submit()`` under a StepClock with a
    seeded pressure-only fault plan: at least 2 requests preempted and
    resumed (prefill of the prompt at batch 1, decode replay of the
    prefix at M = 1), every request FINISHED, tokens held to phase 4's
    under the near-tie rule; ms per resume timed around ``_admit_resume``."""
    S = serve_mod
    plan = S.FaultInjector(seed=PREEMPT_SEED, horizon=32, nan_faults=0,
                           inf_faults=0, transient_failures=0,
                           pressure_windows=2, pressure_len=(3, 5),
                           pressure_frac=(0.12, 0.2), burst_every=0,
                           arrival_lambda=0.0)
    clock = S.StepClock(10.0)
    eng = S.ServingEngine(model, cfg, n_slots=4, max_len=256,
                          dtype=torch.bfloat16, faults=plan, clock=clock,
                          device="cuda")
    resume_s, replayed = [], []
    inner = eng._admit_resume

    def resume(req):
        replayed.append(len(req.tokens) - 1)
        synced_timer(inner, resume_s)(req)
    eng._admit_resume = resume
    reset_counts(dm)
    t0 = time.perf_counter()
    run = serve_queued(eng, prompts, api, clock=clock)
    run_s = time.perf_counter() - t0
    counts = read_counts(dm)
    st = eng.stats()
    assert all(r.state.value == "finished" and len(r.tokens) == MAX_NEW
               for r in run["reqs"]), [r.state for r in run["reqs"]]
    preempted = [i for i, r in enumerate(run["reqs"]) if r.preemptions]
    assert len(preempted) >= 2 and st["resumes"] >= 2, (preempted, st)
    div = near_ties(run["tokens"], base, limit, "preempt_resume")
    res = dict(plan=plan.describe(), preemptions=st["preemptions"],
               resumes=st["resumes"], preempted_requests=preempted,
               replayed_tokens=replayed, ms_per_resume=[t * 1e3
                                                        for t in resume_s],
               engine_steps=st["engine_steps"], run_s=run_s,
               divergences=len(div), divergence_records=div,
               kernel_m=sorted(engine_kernel_m(eng)), **counts)
    log("preempt_resume " + json.dumps(res))
    return res


def phase_guards_faults(api, dm, serve_mod, cfg, model, prompts, base,
                        limit):
    """9b: guards on and a plan injecting NaN and Inf into one row each and
    failing one step transiently, under ``run_to_completion(retry=...)``:
    exactly the injected requests FAILED (with diagnostics), the others
    FINISHED with phase 4's tokens under the near-tie rule; the decode ms
    per step with the guard's counts riding the token transfer, beside
    phase 4's."""
    S = serve_mod
    plan = S.FaultInjector(seed=GUARD_SEED, horizon=24, nan_faults=1,
                           inf_faults=1, pressure_windows=0,
                           transient_failures=1, burst_every=0,
                           arrival_lambda=0.0)
    eng = S.ServingEngine(model, cfg, n_slots=4, max_len=256,
                          dtype=torch.bfloat16, guards=True, faults=plan,
                          device="cuda")
    injected, faults = {}, [0]
    inner_iv = plan.inject_vector

    def inject_vector(step, n_slots, occupied=()):
        vec = inner_iv(step, n_slots, occupied)
        for s in np.flatnonzero(~np.isfinite(vec)):
            uid = next(u for u, r in eng.active.items() if r.slot == s)
            injected[uid] = step
        return vec
    plan.inject_vector = inject_vector
    step_s = []
    inner_step = eng.step

    def step():
        calls = sum(eng.bucketing.stats.per_shape.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = inner_step()
        except S.EngineFault:
            faults[0] += 1
            raise
        torch.cuda.synchronize()
        if out and calls == sum(eng.bucketing.stats.per_shape.values()):
            step_s.append(time.perf_counter() - t0)
        return out
    eng.step = step
    reset_counts(dm)
    uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_to_completion(max_steps=200,
                          retry=S.RetryPolicy(max_attempts=4, backoff_s=0.0))
    counts = read_counts(dm)
    fin = eng.take_finished()
    failed = {u for u in uids if fin[u].state.value == "failed"}
    assert injected and failed == set(injected), (failed, injected)
    assert faults[0] >= 1, "no transient step failure was planned in the run"
    for u in uids:
        r = fin[u]
        if u in failed:
            d = r.diagnostics
            assert d["kind"] == "nonfinite_logits" and d["phase"] == "decode"
            assert d["engine_step"] == injected[u] and d["nonfinite"] > 0
        else:
            assert r.state.value == "finished" and len(r.tokens) == MAX_NEW
    div = near_ties([fin[u].tokens for u in uids], base, limit,
                    "guards_faults")
    res = dict(plan=plan.describe(), injected={str(u): s for u, s in
                                               injected.items()},
               failed=sorted(failed), transient_faults=faults[0],
               diagnostics=[fin[u].diagnostics for u in sorted(failed)],
               decode_steps=len(step_s),
               decode_ms_per_step=float(np.mean(step_s)) * 1e3,
               decode_ms_per_step_min=float(np.min(step_s)) * 1e3,
               phase4_decode_ms_per_step=base["decode_ms_per_step"],
               phase4_decode_ms_per_step_min=base["decode_ms_per_step_min"],
               divergences=len(div), divergence_records=div,
               kernel_m=sorted(engine_kernel_m(eng)), **counts)
    log("guards_faults " + json.dumps(res))
    return res


def phase_chunked(api, dm, serve_mod, cfg, model, limit, host_gen):
    """9c: four long prompts (``CHUNK_PROMPT_LENS``), two submitted at
    step 0 and one each at steps 3 and 5, served with 64-token chunks
    under a 64-token budget (chunks interleave with the running requests'
    decode) and monolithically on the same schedule: tokens held to the
    monolithic run's under the near-tie rule, prefill ms of both."""
    S = serve_mod
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=host_gen).tolist()
               for n in CHUNK_PROMPT_LENS]
    at = [0, 0, 3, 5]
    kw = dict(n_slots=4, max_len=256, dtype=torch.bfloat16, device="cuda")
    out = {}
    for tag, chunked in (("monolithic", None),
                         ("chunked", S.ChunkedPrefillConfig(
                             chunk_tokens=CHUNK_TOKENS,
                             budget_tokens=CHUNK_TOKENS))):
        eng = S.ServingEngine(model, cfg, chunked_prefill=chunked, **kw)
        spent = []
        if chunked is None:
            eng._prefill = synced_timer(eng._prefill, spent)
        else:
            eng._run_chunk = synced_timer(eng._run_chunk, spent)
        reset_counts(dm)
        run = serve_queued(eng, prompts, api, submit_at=at,
                           record=chunked is None)
        counts = read_counts(dm)
        assert all(r.state.value == "finished" and len(r.tokens) == MAX_NEW
                   for r in run["reqs"])
        if chunked is None:
            assert all(sorted(r) == list(range(1, MAX_NEW))
                       for r in run["decode_logits"])
            run["prefill_logits"] = prefill_logits(api, eng, cfg, prompts)
        st = eng.stats()
        run.update(prefill_ms=sum(spent) * 1e3, prefill_calls=len(spent),
                   decode_ms_per_step=float(np.mean(run["decode_s"])) * 1e3,
                   kernel_m=sorted(engine_kernel_m(eng)),
                   chunked=st.get("chunked"), **counts)
        out[tag] = run
    div = near_ties(out["chunked"]["tokens"], out["monolithic"], limit,
                    "chunked")
    res = {tag: {k: v for k, v in r.items() if k in (
        "prefill_ms", "prefill_calls", "decode_ms_per_step", "kernel_m",
        "chunked", "launches", "aligned", "gathered")}
        for tag, r in out.items()}
    res.update(prompt_lens=list(CHUNK_PROMPT_LENS), submit_at_step=at,
               divergences=len(div), divergence_records=div)
    log("chunked " + json.dumps(res))
    return res


def storm_engine(serve_mod, cfg, model, draft, clock, controller):
    S = serve_mod
    return S.ServingEngine(
        model, cfg, n_slots=4, max_len=256, dtype=torch.bfloat16,
        draft_params=draft, spec=S.SpecConfig(gamma=GAMMA),
        chunked_prefill=CHUNK_TOKENS, kv_layout="paged",
        page_size=PAGE_SIZE, controller=controller,
        cost_model=S.StepCostModel() if controller is not None else None,
        clock=clock, telemetry=S.Telemetry(), queue_depth=64,
        device="cuda")


def phase_storm(api, dm, serve_mod, cfg, model, draft):
    """9d: the seeded storm (``STORM``) replayed on a speculative engine
    (phase 4b's synthetic draft, gamma 4), chunked, on an fp page pool,
    with the full SLO controller, a StepCostModel and a StepClock: the
    ladder reaches spec_off, the report validates, every request ends
    terminal, and a second replay gives a byte-identical report; the
    Perfetto export's structure.  9e: the same trace on the same engine
    under the wall clock, no controller: TTFT, TPOT and queue wait from
    the port's own spans."""
    import tempfile
    S = serve_mod
    trace = S.synthesize_trace(vocab=cfg.vocab, **STORM)
    reports, runs = [], {}
    for i in range(2):
        ctl = S.AdmissionController(S.SLOConfig(ttft_p99_ms=STORM_TTFT_MS),
                                    mode="full")
        eng = storm_engine(S, cfg, model, draft, S.StepClock(10.0), ctl)
        reset_counts(dm)
        t0 = time.perf_counter()
        rep = S.Replayer(eng, trace,
                         retry=S.RetryPolicy(backoff_s=0.0)).run()
        runs[f"replay_{i}"] = dict(run_s=time.perf_counter() - t0,
                                   kernel_m=sorted(engine_kernel_m(eng)),
                                   **read_counts(dm))
        S.validate_report(rep)
        reports.append(json.dumps(rep, sort_keys=True))
        if i == 0:
            first, tel = rep, eng.telemetry
    assert reports[0] == reports[1], "two StepClock replays differ"
    states = [r["state"] for r in first["per_request"]]
    assert all(st in ("finished", "truncated", "abandoned", "failed")
               for st in states), states
    log_ = first["controller"]["decision_log"]
    up = [d["rung_name"] for d in log_ if d["kind"] == "rung_up"]
    assert "spec_off" in up, up
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "storm.perfetto.json"
        S.write_perfetto(str(path), tel)
        doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    tracks = sorted(e["args"]["name"] for e in evs
                    if e["ph"] == "M" and e["name"] == "thread_name")
    assert tracks == ["controller", "queue"] + [f"slot {i}"
                                                for i in range(4)], tracks
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 0 and 1 <= e["tid"] <= 4
                         for e in spans)
    assert {"queue_depth", "active_slots", "pages_in_use"} <= {
        e["name"] for e in evs if e["ph"] == "C"}
    res = dict(trace=dict(STORM, n_arrivals=len(trace)),
               ttft_p99_ms_target=STORM_TTFT_MS,
               rungs_up=up, rung_changes=first["controller"]["rung_changes"],
               sheds=first["controller"]["sheds"],
               defers=first["controller"]["defers"],
               by_state=first["requests"]["by_state"],
               engine_steps=first["engine_steps"],
               virtual=dict(ttft_ms=first["ttft_ms"],
                            tpot_ms=first["tpot_ms"],
                            queue_wait_ms=first["queue_wait_ms"]),
               spec=first["spec"], chunked=first["chunked"],
               paged=first["paged"], report_bytes=len(reports[0]),
               reports_identical=True, perfetto_events=len(evs), **runs)
    log("storm " + json.dumps(res))

    # 9e: the wall clock
    eng = storm_engine(S, cfg, model, draft, None, None)
    reset_counts(dm)
    t0 = time.perf_counter()
    rep = S.Replayer(eng, trace, retry=S.RetryPolicy(backoff_s=0.0)).run()
    wall = dict(run_s=time.perf_counter() - t0,
                kernel_m=sorted(engine_kernel_m(eng)), **read_counts(dm))
    S.validate_report(rep)
    assert rep["ttft_ms"]["count"] > 0
    wall.update({k: rep[k] for k in ("ttft_ms", "tpot_ms", "queue_wait_ms",
                                     "elapsed_s", "engine_steps")},
                by_state=rep["requests"]["by_state"], tokens=rep["tokens"],
                spec=rep["spec"])
    log("storm_wall_clock " + json.dumps(wall))
    for k in ("ttft_ms", "tpot_ms", "queue_wait_ms"):
        h = rep[k]
        log(f"  {k}: p50 {h['p50']:.1f}  p90 {h['p90']:.1f}  p99 "
            f"{h['p99']:.1f}  (n={h['count']})")
    res["wall_clock"] = wall
    return res


def phase_control_plane(api, dm, serve_mod, cfg, model, draft, prompts,
                        base, limit, host_gen):
    """Phase 9: the serving control plane at full width (see the module
    docstring); returns the records by sub-phase."""
    t0 = time.perf_counter()
    out = dict(
        preempt_resume=phase_preempt_resume(api, dm, serve_mod, cfg, model,
                                            prompts, base, limit),
        guards_faults=phase_guards_faults(api, dm, serve_mod, cfg, model,
                                          prompts, base, limit),
        chunked=phase_chunked(api, dm, serve_mod, cfg, model, limit,
                              host_gen),
        storm=phase_storm(api, dm, serve_mod, cfg, model, draft))
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ distribution

def free_port() -> int:
    """A free TCP port on localhost (the one-rank process group's)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh_one_rank(api, dm, ServingEngine, cfg, model, prompts, base):
    """14a: phase 4's model and prompts on a (1, 1) mesh over nccl (world
    size 1, this process): the tokens must be phase 4's exactly."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_debug_mesh((1, 1), device_type="cuda")
        eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                            dtype=torch.bfloat16, device="cuda", mesh=mesh)
        run = drive(eng, prompts, dm, api, cfg, "mesh_1x1")
        assert eng.stats()["mesh"] == {"data": 1, "model": 1}
        assert run["tokens"] == base["tokens"], "the 1x1 mesh left phase 4"
    finally:
        dist.destroy_process_group()
    log("mesh_1x1: tokens exactly phase 4's")
    return run


def mesh_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama1_7b"), n_layers=MESH_DEPTH)


def mesh_model(device):
    """14b's model: full-width llama1_7b at ``MESH_DEPTH`` layers with
    synthetic AP+OR weights from phase 4's seed (the same on every
    rank and in the parent)."""
    return synthetic_model(mesh_cfg(),
                           torch.Generator(device=device).manual_seed(SEED),
                           torch.Generator().manual_seed(SEED), device)


def mesh_serve(eng, prompts, dm):
    """Serve ``prompts`` as ``drive`` admits them (slots as they free up,
    ``MAX_NEW`` tokens each), the launch counts set to 0 just before and
    read just after; per decode step its K1 launches and synchronized
    ms.  Returns (tokens in prompt order, counts, launches a step, decode
    ms a step, the emitting steps run before each request's admission)."""
    reset_counts(dm)
    pending, order, step_ms, step_launches = list(prompts), [], [], []
    admitted = []
    while pending or eng.active:
        if pending and eng.free:
            n = min(len(pending), len(eng.free))
            order += eng.add_requests([pending.pop(0) for _ in range(n)],
                                      max_new_tokens=MAX_NEW)
            admitted += [len(step_ms)] * n
        before = dm.launch_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emitted = eng.step()
        torch.cuda.synchronize()
        if emitted:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches.append(dm.launch_count - before)
    counts = read_counts(dm)
    fin = eng.take_finished()
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == MAX_NEW for u in order)
    return ([fin[u].tokens for u in order], counts, step_launches, step_ms,
            admitted)


def mesh_rank(rank, world, device, prompts, base_tokens, W, H, shared):
    """14b, 14e, 14f and 14d on one of the two spawned ranks (the process
    group is up, gloo on the card): per mesh of ``MESH_SHAPES`` the served
    record, the pod mesh's, the split pool's (``shared``: prompts sharing
    a prefix), then the row-sharded quantizer's result."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.analysis import op_trace as OT
    from repro_torch.analysis.artifacts import decode_ops, verify_engine
    from repro_torch.core import CLAQConfig, claq
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels.plan import PreparedQuantizedTensor, prepare_tree
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine
    cfg = mesh_cfg()
    single = prepare_tree(mesh_model(device))
    out = {}
    for shape in MESH_SHAPES:
        tag = f"mesh_{shape[0]}x{shape[1]}"
        mesh = mesh_lib.make_debug_mesh(shape, device_type="cuda")
        eng = ServingEngine(mesh_model(device), cfg, n_slots=4, max_len=256,
                            dtype=torch.bfloat16, device=device, mesh=mesh)
        t0 = time.perf_counter()
        rep = verify_engine(eng, raise_on_error=False)
        gate_s = time.perf_counter() - t0
        tokens, counts, step_launches, step_ms, _ = mesh_serve(eng, prompts,
                                                               dm)
        colls = OT.collective_instructions(decode_ops(eng))
        planes = sum(p.numel() * 4 for m in eng.params.modules()
                     if isinstance(getattr(m, "kernel", None),
                                   PreparedQuantizedTensor)
                     for g in m.kernel.groups for p in g.planes)
        # the sharding noise: the sharded model against the single-device
        # one on the single-rank engine's tokens, teacher-forced
        noise = 0.0
        with torch.no_grad(), dctx.use_mesh(mesh):
            for p, t in zip(prompts, base_tokens):
                seq = torch.tensor([p + t[:-1]], device=device)
                a, _, _ = api.tf.forward(eng.params, cfg, seq)
                with dctx.use_mesh(None):
                    b, _, _ = api.tf.forward(single, cfg, seq)
                noise = max(noise, float((a.float() - b.float()).abs()
                                         .max()))
        out[tag] = dict(
            tokens=tokens, counts=counts, plane_bytes=planes,
            launches_per_step=sorted(set(step_launches)),
            decode_ms_per_step=float(np.mean(step_ms)),
            decode_ms_per_step_min=float(np.min(step_ms)),
            all_gathers_per_step=sum(k == "all-gather" for k, _ in colls),
            all_gather_bytes_per_step=sum(b for k, b in colls
                                          if k == "all-gather"),
            collectives_per_step=len(colls),
            collective_bytes_max=max((b for _, b in colls), default=0),
            gate_rules=rep.rules_run, weight_shard_ranks=shape[1],
            gate_findings=[(f.rule_id, f.severity.name, f.message[:160])
                           for f in rep.findings],
            gate_s=gate_s, logit_noise=noise, stats_mesh=eng.stats()["mesh"])
        del eng
        torch.cuda.empty_cache()
    del single
    # 14e: the (2, 1) mesh's data ranks as two pods of a (pod, data,
    # model) mesh: slots over "dp" = pod x data, the sampled tokens
    # gathered over both
    mesh = mesh_lib.make_debug_mesh((2, 1, 1), ("pod", "data", "model"),
                                    device_type="cuda")
    eng = ServingEngine(mesh_model(device), cfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, device=device, mesh=mesh)
    tokens, counts, step_launches, step_ms, _ = mesh_serve(eng, prompts, dm)
    out["mesh_pod_2x1x1"] = dict(
        tokens=tokens, counts=counts,
        launches_per_step=sorted(set(step_launches)),
        decode_ms_per_step=float(np.mean(step_ms)),
        decode_ms_per_step_min=float(np.min(step_ms)),
        stats_mesh=eng.stats()["mesh"])
    del eng
    torch.cuda.empty_cache()
    # 14f: a page pool split over "dp", on (2, 1) and on two pods
    out.update(split_pool_rank(device, cfg, prompts, shared, dm,
                               out["mesh_2x1"]["gate_findings"]))
    torch.cuda.empty_cache()
    # 14d: the row-sharded quantizer over the model axis of a (1, 2) mesh
    mesh = mesh_lib.make_debug_mesh((1, 2), device_type="cuda")
    qcfg = CLAQConfig(bits=3, method="kmeans", kmeans_iters=5,
                      gptq_blocksize=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, Q, st = claq.quantize_matrix(torch.from_numpy(W).to(device),
                                    torch.from_numpy(H).to(device), qcfg,
                                    mesh=mesh)
    torch.cuda.synchronize()
    out["rowsharded"] = dict(Q=Q.cpu().numpy(), proxy_loss=st.proxy_loss,
                             seconds=time.perf_counter() - t0)
    return out


def pool_view_check(eng):
    """This rank's view of its slots' pages (layer 0's pools through the
    engine's ``PageRoute``: its own block and the exchange) against the
    same slots' view of a whole-pool replica, built once by gathering the
    blocks over "dp" and read through the whole table with scratch zeroed
    (the split view reads scratch as zeros; it is masked).  Returns
    (bit for bit equal, pages its slots name, of them held elsewhere)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import context as dctx
    from repro_torch.models import layers as L
    c, route, blocks = eng.cache[0], eng._route, eng._blocks
    pools = [(c.kp, c.k_scale), (c.vp, c.v_scale)]
    with dctx.use_mesh(eng.mesh):
        views = L.placed_pool_view(pools, route, torch.bfloat16)
        whole = [[None if t is None else coll.gather_dp(t, eng.mesh)
                  for t in pair] for pair in pools]
    scratch = blocks.parts * blocks.rows - 1
    for pair in whole:
        for t in pair:
            if t is not None:
                t[scratch] = 0
    table = torch.as_tensor(eng._tables[eng._rows], dtype=torch.long,
                            device=c.kp.device)
    replica = [L.pool_view(p, sc, table, torch.bfloat16) for p, sc in whole]
    named = set(eng._tables[eng._rows].ravel().tolist()) - {scratch}
    elsewhere = sum(p // blocks.rows != blocks.index for p in named)
    return (all(torch.equal(a, b) for a, b in zip(views, replica)),
            len(named), elsewhere)


def split_pool_serve(eng, prompts, dm):
    """``mesh_serve`` for 14f: per admission its synchronized ms, the
    engine's (Bb, bucket) of every prefill and the (rows, tokens) this
    rank ran (hooks on ``bucketing.record`` and ``models.api.
    prefill_step``); at the ``SPLIT_VIEW_STEP``-th emitting step the
    view check (``pool_view_check``) and the op trace of one decode step
    on a clone of the cache (``decode_ops``; the launch counts restored
    around it).  Returns the record."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.analysis.artifacts import decode_ops
    from repro_torch.models import api
    shapes, ran = [], []
    run_prefill, record = api.prefill_step, eng.bucketing.record

    def prefill(params, cfg, batch, cache, **kw):
        ran.append(tuple(batch["tokens"].shape))
        return run_prefill(params, cfg, batch, cache, **kw)

    def bucketed(b, n):
        shapes.append((b, n))
        return record(b, n)
    api.prefill_step, eng.bucketing.record = prefill, bucketed
    reset_counts(dm)
    pending, order, step_ms, prefill_ms, launches = list(prompts), [], [], \
        [], []
    view = trace = None
    try:
        while pending or eng.active:
            if pending and eng.free:
                n = min(len(pending), len(eng.free))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                order += eng.add_requests([pending.pop(0) for _ in range(n)],
                                          max_new_tokens=MAX_NEW)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            before = dm.launch_count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emitted = eng.step()
            torch.cuda.synchronize()
            if emitted:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(dm.launch_count - before)
            if len(step_ms) == SPLIT_VIEW_STEP and view is None:
                view = pool_view_check(eng)
                kept = read_counts(dm)
                trace = decode_ops(eng)
                reset_counts(dm)
                dm.launch_count = kept["launches"]
                dm.aligned_launch_count = kept["aligned"]
                dm.int8_launch_count = kept["int8"]
    finally:
        api.prefill_step = run_prefill
        del eng.bucketing.record
    counts = read_counts(dm)
    fin = eng.take_finished()
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == MAX_NEW for u in order)
    colls = OT.collective_instructions(trace)
    a2a = [b for k, b in colls if k == "all-to-all"]
    return dict(
        tokens=[fin[u].tokens for u in order], counts=counts,
        launches_per_step=sorted(set(launches)),
        prefill_shapes=shapes, prefill_rows_ran=ran,
        prefill_ms_per_admission=float(np.mean(prefill_ms)),
        prefill_ms_per_admission_min=float(np.min(prefill_ms)),
        decode_ms_per_step=float(np.mean(step_ms)),
        decode_ms_per_step_min=float(np.min(step_ms)),
        view_equal=view[0], view_pages_named=view[1],
        view_pages_elsewhere=view[2],
        exchanges_per_step=len(a2a), exchange_bytes_per_step=sum(a2a),
        fragment_bytes_in=eng.fragment_bytes_in,
        collectives_per_step=collective_counts(colls),
        to_host_per_step=OT.transfer_counts(trace)["to_host"])


def split_pool_rank(device, cfg, prompts, shared, dm, contiguous_gate):
    """14f on one rank: llama1_7b (``MESH_DEPTH`` layers, full width) from
    a pool of ``SPLIT_POOL_PAGES`` + 1 page rows split over "dp" (32 a
    rank), bf16 and int8 pages, on the (2, 1) mesh and on two pods of a
    (2, 1, 1) mesh; on (2, 1) the contract gate at construction (its
    findings beside the contiguous engine's, ``contiguous_gate``) and,
    on bf16 pages, prompts sharing a prefix after phase 4's (their
    copy-on-write pairs recorded).  Returns the records."""
    from repro_torch.analysis.artifacts import verify_engine
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import ServingEngine
    meshes = {
        "2x1": mesh_lib.make_debug_mesh((2, 1), device_type="cuda"),
        "pod_2x1x1": mesh_lib.make_debug_mesh(
            (2, 1, 1), ("pod", "data", "model"), device_type="cuda")}
    model = mesh_model(device)
    out = {}
    for mtag, mesh in meshes.items():
        for kv in ("bf16", "int8"):
            tag = f"split_pool_{mtag}_{kv}"
            eng = ServingEngine(
                model, cfg, n_slots=4, max_len=256, dtype=torch.bfloat16,
                device=device, mesh=mesh, kv_layout="paged",
                page_size=PAGE_SIZE, kv_pages=SPLIT_POOL_PAGES,
                kv_dtype=None if kv == "bf16" else "int8")
            rec = {}
            if mtag == "2x1":
                rep = verify_engine(eng, raise_on_error=False)
                rec.update(gate_rules=rep.rules_run, gate_findings=[
                    (f.rule_id, f.severity.name, f.message[:160])
                    for f in rep.findings],
                    contiguous_gate_findings=contiguous_gate)
            pools = [t for c in eng.cache for f in ("kp", "vp", "k_scale",
                                                    "v_scale")
                     for t in [getattr(c, f)] if t is not None]
            pairs = []
            copy_pages = eng._copy_pages

            def recorded(p, copy_pages=copy_pages, pairs=pairs):
                pairs.extend((int(o), int(n)) for o, n in p)
                copy_pages(p)
            eng._copy_pages = recorded
            rec.update(split_pool_serve(eng, prompts, dm))
            rec.update(pool_rows=sorted({t.shape[0] for t in pools}),
                       pool_bytes_rank=sum(t.numel() * t.element_size()
                                           for t in pools),
                       dp_ranks=eng._blocks.parts,
                       stats_mesh=eng.stats()["mesh"])
            if (mtag, kv) == ("2x1", "bf16"):
                order, pending = [], list(shared)
                while pending or eng.active:     # drive's one_by_one
                    if pending and eng.free:
                        order += eng.add_requests([pending.pop(0)],
                                                  max_new_tokens=MAX_NEW)
                    eng.step()
                fin = eng.take_finished()
                rec.update(shared_tokens=[fin[u].tokens for u in order],
                           prefix_hits=eng.stats()["paged"]["prefix_hits"])
            rows = eng._blocks.rows
            rec.update(cow_pairs=len(pairs), cow_pairs_across_ranks=sum(
                o // rows != n // rows for o, n in pairs))
            out[tag] = rec
            del eng
    return out


def shard_local_kernels(dm, ops, plan, gen, host_gen):
    """14c: K1 and K1e on shard-local plans of llama1_7b's three matrix
    shapes (AP plans at the default tile) for tp = 2, 4, 8 where the tiles
    divide, first and last block, at decode M = 4 (2 per data rank of a
    (2, 2) mesh too) and a prefill M of 64: each launch against its plain
    version (rtol 1e-4, atol 1e-3), and the blocks' outputs against the
    whole plan's launch columns (K1's K split follows N, so the sums may
    differ in order: the gap is reported, not bounded)."""
    cases, max_err, gaps = [], 0.0, {}
    for rows, cols in LLAMA_SHAPES:
        whole = plan.prepare_for_inference(
            synthetic_qt(rows, cols, gen, host_gen, "cuda"))
        for tp in (2, 4, 8):
            if not whole.shards_whole_tiles(tp):
                continue
            for index in sorted({0, tp - 1}):
                local = plan.local_plan(whole, tp, index)
                lo = index * local.n_padded
                for m in (2, 4, 64):
                    x = torch.randn((m, cols), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    for act in ("f32", "int8"):
                        xk, scale = ((x, None) if act == "f32"
                                     else ops.quantize_activations(x))
                        ys = []
                        for pqt in (local, whole):
                            acc, err = None, 0.0
                            for xg, kw in ops.group_calls(xk, pqt, "kernel",
                                                          x_scale=scale):
                                yk = dm.dequant_matmul(
                                    xg, acc=acc, compute_dtype=torch.bfloat16,
                                    **kw)
                                yp = dm.dequant_matmul_plain(
                                    xg, acc=acc, compute_dtype=torch.bfloat16,
                                    **kw)
                                torch.cuda.synchronize()
                                diff = (yk - yp).abs()
                                assert torch.isfinite(yk).all()
                                assert not (diff > ATOL + RTOL * yp.abs()
                                            ).any(), (rows, cols, tp, index,
                                                      m, act)
                                err = max(err, float(diff.max()))
                                acc = yk
                            ys.append(acc)
                            if pqt is local:
                                max_err = max(max_err, err)
                        n = min(local.n_padded, rows - lo)
                        gap = float((ys[0][:, :n] - ys[1][:, lo:lo + n])
                                    .abs().max())
                        key = f"{n}x{cols}"
                        gaps[(key, act)] = max(gaps.get((key, act), 0.0), gap)
                        cases.append(dict(shape=f"{rows}x{cols}", tp=tp,
                                          block=index, m=m, act=act,
                                          local_rows=n, max_abs_err=err,
                                          gap_to_whole=gap))
        del whole
    torch.cuda.empty_cache()
    return cases, max_err, gaps


def phase_distribution(api, dm, ops, plan, ServingEngine, prompts, gen,
                       host_gen):
    """14b-f (14a runs over phase 4's model before it is freed)."""
    from repro_torch.core import CLAQConfig, claq
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    cfg = mesh_cfg()
    # the single-rank engine: the baseline tokens and decode logits
    base = drive(ServingEngine(mesh_model("cuda"), cfg, n_slots=4,
                               max_len=256, dtype=torch.bfloat16,
                               device="cuda"),
                 prompts, dm, api, cfg, "mesh_single_rank",
                 prefill_rows=True)
    # 14d's matrix and its single-rank quantization on the card
    rng = np.random.default_rng(SEED)
    W = rng.normal(size=(ROWSHARD_N, ROWSHARD_N)).astype(np.float32)
    X = rng.normal(size=(4 * ROWSHARD_N, ROWSHARD_N)).astype(np.float32)
    H = (2 * X.T @ X).astype(np.float32)
    qcfg = CLAQConfig(bits=3, method="kmeans", kmeans_iters=5,
                      gptq_blocksize=32)
    torch.cuda.synchronize()
    tq = time.perf_counter()
    _, Q1, st1 = claq.quantize_matrix(torch.from_numpy(W).to("cuda"),
                                      torch.from_numpy(H).to("cuda"), qcfg)
    torch.cuda.synchronize()
    q1_s = time.perf_counter() - tq
    Q1 = Q1.cpu().numpy()
    torch.cuda.empty_cache()
    # 14f's single-rank paged engines (the pool whole): phase 4's prompts
    # on bf16 and int8 pages, then prompts sharing a prefix on bf16 pages
    host = torch.Generator().manual_seed(SEED + 14)
    prefix = torch.randint(1, cfg.vocab, (PREFIX_LEN,),
                           generator=host).tolist()
    shared = [prefix + torch.randint(1, cfg.vocab, (n,),
                                     generator=host).tolist()
              for n in PREFIX_SUFFIXES]
    single_paged, shared_base = {}, None
    for kv in ("bf16", "int8"):
        eng = ServingEngine(mesh_model("cuda"), cfg, n_slots=4, max_len=256,
                            dtype=torch.bfloat16, device="cuda",
                            kv_layout="paged", page_size=PAGE_SIZE,
                            kv_pages=SPLIT_POOL_PAGES,
                            kv_dtype=None if kv == "bf16" else "int8")
        single_paged[kv] = drive(eng, prompts, dm, api, cfg,
                                 f"split_pool_single_rank_{kv}",
                                 prefill_rows=True)
        single_paged[kv]["pool_bytes"] = sum(
            t.numel() * t.element_size() for c in eng.cache
            for t in (c.kp, c.vp, c.k_scale, c.v_scale) if t is not None)
        if kv == "bf16":
            shared_base = drive(eng, shared, dm, api, cfg,
                                "split_pool_single_rank_shared",
                                one_by_one=True, prefill_rows=True)
        del eng
    torch.cuda.empty_cache()
    assert single_paged["bf16"]["tokens"] == base["tokens"]
    # 14b, 14e, 14f + 14d: two ranks share the card over gloo
    card_memory("phase 14's ranks")
    ranks = mesh_lib.run_local(mesh_rank, 2, prompts, base["tokens"], W, H,
                               shared, backend="gloo", device="cuda",
                               workdir=str(REPO / "build"))
    res = {"single_rank": {k: base[k] for k in (
        "decode_ms_per_step", "main_path_launches",
        "launches_per_decode_step")}}
    for shape in MESH_SHAPES:
        tag = f"mesh_{shape[0]}x{shape[1]}"
        for r, out in enumerate(ranks):
            rec = out[tag]
            limit = 2 * rec["logit_noise"]
            ties = near_ties(rec["tokens"], base, limit, f"{tag} rank {r}",
                             ulps=2)
            assert rec["stats_mesh"] == {"data": shape[0],
                                         "model": shape[1]}
            assert rec["launches_per_step"] == [
                base["launches_per_decode_step"]], rec["launches_per_step"]
            assert rec["counts"]["launches"] > 0
            # the collective rules run where a unit splits over "model"
            # (on (2, 1) no weight is sharded, and they skip)
            assert (shape[1] == 1 or ("HLO-AG1" in rec["gate_rules"]
                                      and "HLO-CB1" in rec["gate_rules"])), \
                rec["gate_rules"]
            assert not [f for f in rec["gate_findings"]
                        if f[0] in ("HLO-AG1", "HLO-CB1")], rec
            rec = {k: v for k, v in rec.items() if k != "tokens"}
            rec.update(near_tie_limit=limit, near_ties=len(ties),
                       tokens_equal=out[tag]["tokens"] == base["tokens"])
            res[f"{tag}_rank{r}"] = rec
            log(f"{tag} rank {r} " + json.dumps(rec))
    # 14e: two pods emit the (2, 1) mesh's tokens, bit for bit
    for r, out in enumerate(ranks):
        rec = dict(out["mesh_pod_2x1x1"])
        assert rec.pop("tokens") == out["mesh_2x1"]["tokens"], r
        assert rec["stats_mesh"] == {"pod": 2, "data": 1, "model": 1}
        assert rec["launches_per_step"] == [
            base["launches_per_decode_step"]], rec["launches_per_step"]
        assert rec["counts"]["launches"] > 0
        res[f"mesh_pod_2x1x1_rank{r}"] = rec
        log(f"mesh_pod_2x1x1 rank {r} (tokens exactly the (2, 1) mesh's) "
            + json.dumps(rec))
    # 14f: the split pool
    res.update(judge_split_pool(ranks, single_paged, shared_base, res))
    for r, out in enumerate(ranks):
        q = out["rowsharded"]
        np.testing.assert_allclose(q["Q"], Q1, rtol=1e-4, atol=1e-5)
        assert abs(q["proxy_loss"] - st1.proxy_loss) <= \
            1e-3 * abs(st1.proxy_loss)
        res[f"rowsharded_rank{r}"] = dict(
            seconds=q["seconds"], proxy_loss=q["proxy_loss"],
            max_abs_diff=float(np.abs(q["Q"] - Q1).max()))
    res["rowsharded_single"] = dict(seconds=q1_s, proxy_loss=st1.proxy_loss)
    log("rowsharded " + json.dumps({k: v for k, v in res.items()
                                    if k.startswith("rowsharded")}))
    # 14c
    cases, max_err, gaps = shard_local_kernels(dm, ops, plan, gen, host_gen)
    res["shard_local"] = dict(
        cases=len(cases), max_abs_err=max_err,
        gap_to_whole={f"{k} {a}": g for (k, a), g in sorted(gaps.items())},
        all_gaps_zero=all(g == 0.0 for g in gaps.values()))
    log("shard_local " + json.dumps(res["shard_local"]))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 14b-f took {res['phase_s']:.1f} s")
    return res


def judge_split_pool(ranks, single_paged, shared_base, res):
    """14f's rules over the ranks' records: every rank holds 32 of the 64
    page rows, half the whole pool's bytes; its view of its slots' pages
    at one decode step is the whole pool's bit for bit, and across the
    ranks the exchange moved pages; a prefill of Bb rows ran Bb/2 on a
    rank where 2 divides Bb, else Bb; one transfer to the host a step;
    the gate finds nothing the contiguous (2, 1) engine's does not (its
    HLO-AG1 / HLO-CB1 skip: no weight splits over model = 1); K1's
    launches a step are the single rank's; the tokens meet the
    single-rank paged engine's under 14b's near-tie rule (limit twice the
    (2, 1) placement's logit noise, at least two bf16 steps) and the two
    pods emit the (2, 1) run's tokens bit for bit; the prompts sharing a
    prefix copy a page across ranks.  Returns the records, logged with
    the card's name and power limit."""
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out, ms = {}, set()
    moved = 0
    for kv in ("bf16", "int8"):
        one = single_paged[kv]
        for mtag in ("2x1", "pod_2x1x1"):
            tag = f"split_pool_{mtag}_{kv}"
            for r, rk in enumerate(ranks):
                rec = dict(rk[tag])
                tokens = rec.pop("tokens")
                limit = 2 * res[f"mesh_2x1_rank{r}"]["logit_noise"]
                ties = near_ties(tokens, one, limit, f"{tag} rank {r}",
                                 ulps=2)
                if mtag == "pod_2x1x1":
                    assert tokens == rk[f"split_pool_2x1_{kv}"]["tokens"], \
                        (tag, r, "the pods left the (2, 1) run's tokens")
                assert rec["pool_rows"] == [(SPLIT_POOL_PAGES + 1) // 2], rec
                assert 2 * rec["pool_bytes_rank"] == one["pool_bytes"], rec
                assert rec["view_equal"], (tag, r)
                moved += rec["view_pages_elsewhere"]
                assert rec["prefill_rows_ran"] == [
                    (b // 2 if b % 2 == 0 else b, n)
                    for b, n in rec["prefill_shapes"]], rec
                ms |= {b * n for b, n in rec["prefill_rows_ran"]}
                assert rec["to_host_per_step"] == 1, rec
                assert rec["launches_per_step"] == [
                    one["launches_per_decode_step"]], rec
                assert rec["counts"]["launches"] > 0
                if "gate_findings" in rec:
                    errors = {f[0] for f in rec["gate_findings"]
                              if f[1] == "ERROR"}
                    allowed = {f[0] for f in rec["contiguous_gate_findings"]
                               if f[1] == "ERROR"}
                    assert not errors - allowed, (tag, r, errors, allowed)
                    assert not [f for f in rec["gate_findings"]
                                if f[0] in ("HLO-AG1", "HLO-CB1")], rec
                    rec.pop("contiguous_gate_findings")
                if "shared_tokens" in rec:
                    shared_ties = near_ties(rec.pop("shared_tokens"),
                                            shared_base, limit,
                                            f"{tag} shared rank {r}", ulps=2)
                    rec.update(shared_near_ties=len(shared_ties))
                assert rec["cow_pairs_across_ranks"] > 0, rec
                rec.update(gpu=gpu, near_tie_limit=limit, near_ties=len(ties),
                           tokens_equal=tokens == one["tokens"],
                           pool_bytes_whole=one["pool_bytes"],
                           single_rank_decode_ms_per_step=one[
                               "decode_ms_per_step"],
                           single_rank_prefill_ms=one["prefill_ms"])
                out[f"{tag}_rank{r}"] = rec
                log(f"{tag} rank {r} " + json.dumps(rec))
    assert moved > 0, "no rank read a page another rank holds"
    # the M values a rank's prefills gave K1 (its decode's n_slots / 2 = 2
    # is 14b's, held by 14c)
    out["split_pool_m"] = sorted(ms)
    out["split_pool_single_rank"] = {
        kv: {k: single_paged[kv][k] for k in (
            "decode_ms_per_step", "prefill_ms", "main_path_launches",
            "pool_bytes")} for kv in single_paged}
    return out


def bf16_ulp(x: float) -> float:
    """One bf16 step at ``x`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))


def mesh_train_setup():
    """15a's model config, optimizer config and batches: llama1_7b at full
    width cut to ``QUANT_DEPTH`` layers (bf16 params, f32 moments),
    phase 10's schedule, ``MESH_TRAIN_STEPS`` batches of B ``TRAIN_B`` x S
    ``TRAIN_S`` from ``SyntheticCorpus``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import OptimConfig
    cfg = dataclasses.replace(get_config("llama1_7b"), n_layers=QUANT_DEPTH)
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                      batch=TRAIN_B, seed=SEED))
    return cfg, ocfg, [data.batch_at(s) for s in range(MESH_TRAIN_STEPS)]


def collective_counts(colls):
    """{kind: {"count", "bytes"}} of an op trace's collectives."""
    out = {}
    for kind, b in colls:
        n, tot = out.get(kind, (0, 0))
        out[kind] = (n + 1, tot + b)
    return {k: {"count": n, "bytes": b} for k, (n, b) in sorted(out.items())}


def mesh_train(device, mesh, dm, n_microbatches=1, setup=None):
    """15a (16c, 17c, 18b: ``setup`` ``moe_train_setup``,
    ``rwkv_train_setup``, ``encdec_train_setup``, whose batches are
    tokens or, for encdec, dicts with frames) on one rank (``mesh``
    None: the single-rank baseline): the setup's steps from the seed under
    deterministic algorithms, step ``MESH_TRAIN_TRACE`` under the op
    recorder.  Returns (record, the whole params after the last step: a
    mesh's blocks all-gathered).  K1's counts are set to 0 before and read
    after: fp training launches none."""
    from repro_torch import convert
    from repro_torch.analysis import op_trace as OT
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import gathered_state
    from repro_torch.models import api
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    cfg, ocfg, batches = (setup or mesh_train_setup)()
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = api.init_params(torch.Generator(device=device).manual_seed(
            SEED + 5), cfg, device)
        if mesh is not None:
            shd.place_model(model, cfg, mesh)
        opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
        step = make_train_step(cfg, ocfg, n_microbatches)
        reset_counts(dm)
        losses, norms, step_ms, colls = [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with dctx.use_mesh(mesh):
            for s, batch in enumerate(batches):
                def one(batch=batch):
                    return step(model, opt, batch if isinstance(batch, dict)
                                else {"tokens": batch})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if s == MESH_TRAIN_TRACE:
                    (model, opt, met), trace = OT.capture(one, device)
                    colls = OT.collective_instructions(trace)
                else:
                    model, opt, met = one()
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
                torch.cuda.synchronize()
                if s not in (0, MESH_TRAIN_TRACE):
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            params = (convert.param_tree(model, cfg) if mesh is None
                      else gathered_state(model, cfg, None, mesh)["params"])
        counts = read_counts(dm)
    finally:
        torch.use_deterministic_algorithms(det)
    rec = dict(losses=losses, grad_norms=norms,
               ms_per_step=float(np.mean(step_ms)),
               ms_per_step_min=float(np.min(step_ms)),
               max_memory_allocated_gb=peak / 1e9,
               collectives_per_step=collective_counts(colls),
               k1_launches=counts["launches"])
    return rec, params


def param_gaps(params, want, span):
    """The whole params of a run against the single rank's (host
    tensors): the largest gap, the share of elements more than one bf16
    step of their value apart, and the L2 norm of the difference over
    ``span`` (the L2 norm of the single rank's own distance from the
    init): the relative departure of the run from the single rank's."""
    from repro_torch import tree as tree_lib
    worst, beyond, total, sq = 0.0, 0, 0, 0.0
    for a, b in zip(tree_lib.tensors(params), want):
        a = a.float()
        b = b.to(a.device).float()
        d = (a - b).abs()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30)))
                         - 7)
        worst = max(worst, float(d.max()))
        beyond += int((d > ulp).sum())
        total += d.numel()
        sq += float((d * d).sum())
    return dict(param_max_gap=worst, param_share_beyond_bf16_step=beyond
                / total, param_departure=float(np.sqrt(sq)) / span)


def init_span(params, cfg):
    """The L2 norm of ``params`` minus the seeded init's (15a's model)."""
    from repro_torch import convert
    from repro_torch import tree as tree_lib
    from repro_torch.models import api
    init = api.init_params(torch.Generator(device="cuda").manual_seed(
        SEED + 5), cfg, "cuda")
    return float(np.sqrt(sum(
        float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(
            tree_lib.tensors(params),
            tree_lib.tensors(convert.param_tree(init, cfg))))))


def mesh_train_rank(rank, world, device, want_path, span, setup=None):
    """15a (16c) on one of the two spawned ranks: per mesh of
    ``MESH_SHAPES`` the train record and its params' gaps to the single
    rank's."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.launch import mesh as mesh_lib
    want = torch.load(want_path)
    out = {}
    for shape in MESH_SHAPES:
        mesh = mesh_lib.make_debug_mesh(shape, device_type="cuda")
        rec, params = mesh_train(device, mesh, dm, setup=setup)
        rec.update(param_gaps(params, want, span))
        out[f"train_{shape[0]}x{shape[1]}"] = rec
        del params
        torch.cuda.empty_cache()
    return out


def train_baseline(dm, setup, want_path):
    """The single-rank run of a mesh-training phase and its two-microbatch
    twin (the same steps, the gradients summed in another order: the
    yardstick of the params' tolerance); the single rank's params saved
    to ``want_path`` for the ranks.  Returns (record, span)."""
    from repro_torch import tree as tree_lib
    cfg, _, _ = setup()
    single, params = mesh_train("cuda", None, dm, setup=setup)
    span = init_span(params, cfg)
    want = [t.detach().cpu() for t in tree_lib.tensors(params)]
    del params
    micro, params = mesh_train("cuda", None, dm, n_microbatches=2,
                               setup=setup)
    single["microbatch_twin"] = dict(losses=micro["losses"],
                                     **param_gaps(params, want, span))
    del params
    want_path.parent.mkdir(exist_ok=True)
    torch.save(want, want_path)
    del want
    torch.cuda.empty_cache()
    return single, span


def check_train_ranks(single, ranks, res, what):
    """15a's rules over each rank's train records (``res`` gets them):
    the step-0 loss (forward only) within 1e-3 of the single rank's, every
    later loss within one bf16 step at its value, the whole params'
    departure at most twice the two-microbatch twin's, no K1 launch.
    Returns the largest loss gap."""
    twin = single["microbatch_twin"]["param_departure"]
    loss_tols = [1e-3] + [bf16_ulp(x) for x in single["losses"][1:]]
    worst_loss = 0.0
    for r, out in enumerate(ranks):
        for tag, rec in out.items():
            if not tag.startswith("train_"):
                continue
            gaps = [abs(a - b) for a, b in zip(rec["losses"],
                                               single["losses"])]
            assert all(np.isfinite(rec["losses"])), (tag, rec["losses"])
            assert all(g <= t for g, t in zip(gaps, loss_tols)), \
                (what, tag, r, gaps, loss_tols)
            # bf16 params and activations: every op rounds, so a run whose
            # sums go in another order departs from the single rank's by
            # rounding alone; the mesh may depart at most twice as far as
            # the single rank's own two-microbatch twin (a missing or
            # doubled gradient sum departs by the whole update, ~1)
            assert rec["param_departure"] <= 2 * twin, (what, tag, r, rec,
                                                        twin)
            assert rec["k1_launches"] == 0
            worst_loss = max(worst_loss, max(gaps))
            rec.update(loss_gaps=gaps, loss_tolerances=loss_tols)
            res[f"{tag}_rank{r}"] = rec
            log(f"{what} {tag} rank {r} " + json.dumps(rec))
    log(f"{what}: largest loss gap {worst_loss:.3g} (step 0 held to 1e-3, "
        f"later steps to one bf16 step at the loss: {loss_tols[1:]})")
    return worst_loss


def phase_mesh_train(dm, dist_runs):
    """15. Training on a (data, model) mesh and the dry run against it."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.configs import ShapeCell
    from repro_torch.dist.standin import StandInMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    # 15a: the single-rank baseline and its two-microbatch twin, then two
    # ranks sharing the card
    cfg, _, _ = mesh_train_setup()
    want_path = REPO / "build" / "phase15_params.pt"
    single, span = train_baseline(dm, mesh_train_setup, want_path)
    card_memory("phase 15's ranks")
    try:
        ranks = mesh_lib.run_local(mesh_train_rank, 2, str(want_path), span,
                                   backend="gloo", device="cuda",
                                   workdir=str(REPO / "build"))
    finally:
        want_path.unlink(missing_ok=True)
    res = {"single_rank": single}
    log("train single rank " + json.dumps(single))
    res["largest_loss_gap"] = check_train_ranks(single, ranks, res,
                                                "mesh train")
    # 15b: the dry run against the card
    predicted = {}
    for shape in MESH_SHAPES:
        tag = f"train_{shape[0]}x{shape[1]}"
        traced = dryrun.trace_cell(
            cfg, ShapeCell(tag, TRAIN_S, TRAIN_B, "train"),
            StandInMesh({"data": shape[0], "model": shape[1]}))
        predicted[tag] = collective_counts(
            OT.collective_instructions(traced["trace"]))
        for r in range(len(ranks)):
            got = res[f"{tag}_rank{r}"]["collectives_per_step"]
            assert got == predicted[tag], (tag, r, got, predicted[tag])
    traced = dryrun.trace_cell(
        mesh_cfg(), ShapeCell("mesh_decode", 256, 4, "decode"),
        StandInMesh({"data": 1, "model": 2}), quant="2.12")
    colls = OT.collective_instructions(traced["trace"])
    ag = [b for k, b in colls if k == "all-gather"]
    predicted["decode_1x2"] = dict(all_gathers_per_step=len(ag),
                                   all_gather_bytes_per_step=sum(ag))
    for r in range(2):
        rec = dist_runs[f"mesh_1x2_rank{r}"]
        got = {k: rec[k] for k in predicted["decode_1x2"]}
        assert got == predicted["decode_1x2"], (r, got, predicted)
    res["dry_run_predicted"] = predicted
    log("dry run predicted = measured " + json.dumps(predicted))
    t_roof = time.perf_counter()
    roof = {}
    for shape in ("decode_32k", "train_4k"):
        cell = dryrun.run_cell("llama1_7b", shape, False)
        assert cell["status"] == "ok", cell
        roof[shape] = dict(roofline=cell["roofline"],
                           collectives=cell["per_device"]["collectives"],
                           trace_s=cell["compile_s"])
    res["roofline_single_production_mesh"] = roof
    log("dry-run roofline, llama1_7b on the single production mesh (16x16 "
        "= 256 cards; a model on the H100 data sheet's figures, not a "
        f"measurement; {time.perf_counter() - t_roof:.1f} s) "
        + json.dumps(roof))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 15 took {res['phase_s']:.1f} s")
    return res


def moe_mesh_cfg(arch):
    """16a's qwen3_moe_30b_a3b at full width, ``MOE_MESH_DEPTH`` layers;
    16b's deepseek_v2_236b at full width, 1 layer."""
    from repro_torch.configs import get_config
    if arch == "qwen3_moe":
        return dataclasses.replace(get_config("qwen3_moe_30b_a3b"),
                                   n_layers=MOE_MESH_DEPTH)
    return dataclasses.replace(get_config("deepseek_v2_236b"), n_layers=1)


def moe_mesh_model(arch, device):
    """16a/b's model: synthetic AP+OR weights and experts from the seed
    (the same on every rank and in the parent)."""
    return synthetic_model(moe_mesh_cfg(arch),
                           torch.Generator(device=device).manual_seed(SEED),
                           torch.Generator().manual_seed(SEED), device)


def moe_train_setup():
    """16c's model config, optimizer config and batches: qwen3_moe_30b_a3b
    at full width cut to 1 layer (bf16 params, f32 moments), phase 10's
    schedule, ``MOE_TRAIN_STEPS`` batches of B ``TRAIN_B`` x S ``TRAIN_S``
    from ``SyntheticCorpus``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import OptimConfig
    cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b"), n_layers=1)
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                      batch=TRAIN_B, seed=SEED))
    return cfg, ocfg, [data.batch_at(s) for s in range(MOE_TRAIN_STEPS)]


def dequant_ms(moe_lib, model, flush, reps=5):
    """Device ms of one layer's experts' dequantize (block 0's three
    stacks; a placed stack rebuilds its own rows), CUDA events after an L2
    flush."""
    mlp = model.blocks[0].mlp

    def deq():
        for n in ("w_gate", "w_up", "w_down"):
            moe_lib.expert_weight(getattr(mlp, n), torch.bfloat16)
    torch.cuda.synchronize()
    return time_ms(deq, reps, flush)


class Routing:
    """While open, every call of ``moe.top_k`` (the router's choice of
    experts) is recorded or forced.  Recording (``forced`` None): each
    call's experts and router probabilities land in ``calls`` (on the
    host).  Forcing (``forced``: a recording's ``calls``, made on the same
    sequence of model calls): each call takes the recorded experts, gated
    by this run's own probabilities, and ``diffs`` gets (``time``, the
    recorded k-th minus (k+1)-th probability) for every row whose own
    choice of experts differs from the recorded set; ``noise`` is the
    largest |own - recorded| probability."""

    def __init__(self, moe_lib, forced=None):
        self.lib, self.inner, self.forced = moe_lib, moe_lib.top_k, forced
        self.calls, self.diffs, self.noise, self.time = [], [], 0.0, 0

    def __enter__(self):
        def chosen(probs, k):
            if self.forced is None:
                vals, idx = self.inner(probs, k)
                self.calls.append((idx.cpu(), probs.float().cpu()))
                return vals, idx
            want_idx, want_p = self.forced[len(self.calls)]
            self.calls.append(None)
            own = self.inner(probs, k)[1].cpu()
            self.noise = max(self.noise, float(
                (probs.float().cpu() - want_p).abs().max()))
            top = torch.sort(want_p, dim=-1, descending=True).values
            margin = top[..., k - 1] - top[..., k]
            moved = (torch.sort(own, -1).values
                     != torch.sort(want_idx, -1).values).any(-1)
            self.diffs += [(self.time, float(m)) for m in margin[moved]]
            idx = want_idx.to(probs.device)
            return torch.gather(probs, -1, idx), idx
        self.lib.top_k = chosen
        return self

    def __exit__(self, *exc):
        self.lib.top_k = self.inner


def bf16_step_at(row) -> float:
    """One bf16 step at a logits row's largest magnitude."""
    return float(2.0 ** (np.floor(np.log2(float(row.abs().max()))) - 7))


def forced_replay(eng, prompts, base, moe_lib=None, routing=None):
    """Serve ``prompts`` again through ``eng`` with every sampled token
    forced to the single rank's (``base``: its tokens, batch-1 prefill
    rows and decode logits rows, on the host) and, given the single
    rank's ``routing`` (a ``Routing`` recording of this replay on the
    single rank), every router choice forced to its experts: every step
    runs the single rank's batch through the single rank's experts, so
    what is left between the two is rounding.  Without ``routing`` the
    router choices are recorded (a family without experts, ``moe_lib``
    None: neither routing nor drops).  Returns the largest |replay -
    single| logit gap over every emitted row (``noise``, and in bf16 steps
    at the row's largest logit, ``noise_steps``), the rows, the rows whose
    argmax is not the single rank's token (``flip_deficits``: the single
    rank's logit of its token over its logit of the replay's argmax there;
    ``flips_at``: their (request, token position)), each MoE call's
    capacity drops, the router's noise and its differing choices (time, the
    single rank's margin there; times as ``first_divergences`` counts
    them), and the recording.  The logits are all-gathered over "data" to
    be read (one more collective a step, this replay's only)."""
    from repro_torch.dist import collectives as coll
    order, pending = [], list(prompts)
    index = {}
    admitted, admitting = [], [False]
    st = dict(noise=0.0, noise_steps=0.0, rows=0, flip_deficits=[],
              flips_at=[])

    def held(row, want_row, token, at):
        row = row.float().cpu()
        gap = float((row - want_row).abs().max())
        st["noise"] = max(st["noise"], gap)
        st["noise_steps"] = max(st["noise_steps"],
                                gap / bf16_step_at(want_row))
        st["rows"] += 1
        top = int(row.argmax())
        if top != token:
            st["flip_deficits"].append(float(want_row[token]
                                             - want_row[top]))
            st["flips_at"].append(at)

    def forced(logits, split=False):
        if admitting[0]:    # a moe prefill, or one of distinct length
            assert logits.shape[0] == 1 and not split, logits.shape
            i = index[admitted.pop(0)]
            held(logits[0], base["prefill_logits"][i], base["tokens"][i][0],
                 (i, 0))
            return np.array([base["tokens"][i][0]]), None
        rows = coll.gather_dp(logits, eng.mesh) if split else logits
        out = np.zeros((eng.n_slots,), np.int64)
        for uid, req in eng.active.items():
            i, k = index[uid], len(req.tokens)
            held(rows[req.slot], base["decode_logits"][i][k],
                 base["tokens"][i][k], (i, k))
            out[req.slot] = base["tokens"][i][k]
        return out, None

    steps = 0
    eng._sample = forced
    try:
        with contextlib.ExitStack() as stack:
            route = drops = None
            if moe_lib is not None:
                route = stack.enter_context(Routing(moe_lib, routing))
                drops = stack.enter_context(MoeDrops(moe_lib))
            while pending or eng.active:
                if pending and eng.free:
                    n = min(len(pending), len(eng.free))
                    batch = [pending.pop(0) for _ in range(n)]
                    uids = list(range(eng._uid, eng._uid + n))
                    index.update({u: len(order) + j
                                  for j, u in enumerate(uids)})
                    admitted.extend(uids)
                    if route is not None:
                        route.time = 2 * steps + 1
                    admitting[0] = True
                    got = eng.add_requests(batch, max_new_tokens=MAX_NEW)
                    admitting[0] = False
                    assert got == uids, (got, uids)
                    order += got
                if route is not None:
                    route.time = 2 * (steps + 1)
                steps += bool(eng.step())
    finally:
        del eng._sample
    fin = eng.take_finished()
    assert [fin[u].tokens for u in order] == base["tokens"]
    if route is None:
        return st
    assert routing is None or len(route.calls) == len(routing)
    return dict(st, drops=[int(d) for _, _, d in drops.calls],
                router_noise=route.noise, router_diffs=route.diffs,
                routing=route.calls if routing is None else None)


def moe_mesh_rank(rank, world, device, prompts, want_path, span):
    """16a-c on one of the two spawned ranks: per model and mesh of
    ``MESH_SHAPES`` the served record, then 16c's train records."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.analysis import op_trace as OT
    from repro_torch.analysis.artifacts import decode_ops, verify_engine
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels.plan import PreparedQuantizedTensor
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve import ServingEngine
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    out = {}
    for arch in MOE_MESH_ARCHS:
        cfg = moe_mesh_cfg(arch)
        base = torch.load(REPO / "build" / f"phase16_{arch}.pt")
        whole = moe_mesh_model(arch, device)
        for shape in MESH_SHAPES:
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            mesh = mesh_lib.make_debug_mesh(shape, device_type="cuda")
            t0 = time.perf_counter()
            eng = ServingEngine(copy.deepcopy(whole), cfg, n_slots=4,
                                max_len=256, dtype=torch.bfloat16,
                                device=device, mesh=mesh)
            t1 = time.perf_counter()
            rep = verify_engine(eng, raise_on_error=False)
            t2 = time.perf_counter()
            with MoeDrops(moe_lib) as drops:
                tokens, counts, step_launches, step_ms, admitted = \
                    mesh_serve(eng, prompts, dm)
            t3 = time.perf_counter()
            replay = forced_replay(eng, prompts, base, moe_lib,
                                   routing=base["routing"])
            t4 = time.perf_counter()
            colls = OT.collective_instructions(decode_ops(eng))
            planes = sum(p.numel() * 4 for m in eng.params.modules()
                         if isinstance(getattr(m, "kernel", None),
                                       PreparedQuantizedTensor)
                         for g in m.kernel.groups for p in g.planes)
            ag = [b for k, b in colls if k == "all-gather"]
            out[tag] = dict(
                tokens=tokens, admitted=admitted, counts=counts,
                plane_bytes=planes,
                launches_per_step=sorted(set(step_launches)),
                decode_ms_per_step=float(np.mean(step_ms)),
                decode_ms_per_step_min=float(np.min(step_ms)),
                all_gathers_per_step=len(ag),
                all_gather_bytes_per_step=sum(ag),
                collectives_per_step=collective_counts(colls),
                capacity_drops=drops.summary(cfg)["decode"],
                dequantize_ms_per_layer=dequant_ms(moe_lib, eng.params,
                                                   flush),
                latent_cache_bytes=(sum(t.numel() * t.element_size()
                                        for c in eng.cache
                                        for t in (c.c_kv, c.k_pe))
                                    if cfg.use_mla else None),
                gate_rules=rep.rules_run,
                gate_findings=[(f.rule_id, f.severity.name, f.message[:160])
                               for f in rep.findings],
                replay={k: v for k, v in replay.items() if k != "routing"},
                seconds=dict(engine=t1 - t0, gate=t2 - t1, serve=t3 - t2,
                             replay=t4 - t3),
                stats_mesh=eng.stats()["mesh"])
            if cfg.use_mla and shape == (2, 1):
                # 16b's paged variant: a latent pool of 64 page rows split
                # over "dp", 32 a rank, over this engine's params (whole
                # on (2, 1): nothing splits over model = 1)
                paged = ServingEngine(eng.params, cfg, n_slots=4,
                                      max_len=256, dtype=torch.bfloat16,
                                      device=device, mesh=mesh,
                                      kv_layout="paged", page_size=PAGE_SIZE,
                                      kv_pages=SPLIT_POOL_PAGES)
                del eng
                tokens, counts, step_launches, step_ms, _ = mesh_serve(
                    paged, prompts, dm)
                out[f"{arch}_2x1_paged_split"] = dict(
                    tokens=tokens, counts=counts,
                    launches_per_step=sorted(set(step_launches)),
                    decode_ms_per_step=float(np.mean(step_ms)),
                    decode_ms_per_step_min=float(np.min(step_ms)),
                    pool_rows=sorted({t.shape[0] for c in paged.cache
                                      for t in (c.cp, c.pp)}),
                    latent_pool_bytes_rank=sum(
                        t.numel() * t.element_size() for c in paged.cache
                        for t in (c.cp, c.pp)))
                eng = paged
            del eng
            torch.cuda.empty_cache()
        del whole, base
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out.update(mesh_train_rank(rank, world, device, want_path, span,
                               setup=moe_train_setup))
    out["mesh_train_s"] = time.perf_counter() - t0
    return out


def first_divergences(got, want, admitted):
    """The requests of ``got`` that diverge from ``want`` first in time
    (``got`` with every other request's tokens replaced by ``want``'s, for
    ``near_ties``), the count of the later ones and the time of the first
    (None: no divergence).  A request admitted after k emitting steps
    emits token 0 from its prefill (time 2k + 1) and token j at step k + j
    (time 2(k + j)).  Until a first divergence every row of every step saw
    the single rank's inputs; after it, the MoE's capacity couples every
    row of a step to the changed one, so a later divergence follows from
    it (the forced replay holds every row's computation, ``judge_replay``)."""
    times = {}
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            j = next(k for k, (a, b) in enumerate(zip(g, w)) if a != b)
            times[i] = 2 * admitted[i] + 1 if j == 0 \
                else 2 * (admitted[i] + j)
    if not times:
        return got, 0, None
    t0 = min(times.values())
    first = [g if times.get(i) == t0 else w
             for i, (g, w) in enumerate(zip(got, want))]
    return first, sum(t > t0 for t in times.values()), t0


def judge_replay(rp, single, tag):
    """Hold a rank's forced replay (``forced_replay`` with the single
    rank's routing) to the single rank's (``single``: its own replay):
    every MoE call's capacity drops exactly the single rank's (the same
    experts chosen, the same groups and capacity); the logit noise at most
    ``REPLAY_NOISE_STEPS`` bf16 steps at each row's largest logit, the
    router's at most ``REPLAY_ROUTER_NOISE``, and at most
    ``REPLAY_FLIPS`` argmax flips (ceilings from sound runs).  A flip, or
    a router choice that differs, is then a near tie: the single rank's
    deficit (margin) there is below twice the noise.  Returns the
    readings, logged."""
    out = dict(rows=rp["rows"], noise=rp["noise"],
               noise_steps=rp["noise_steps"], flips=len(rp["flip_deficits"]),
               largest_flip_deficit=max(rp["flip_deficits"], default=0.0),
               router_noise=rp["router_noise"],
               router_differences=len(rp["router_diffs"]),
               largest_router_margin=max(
                   (m for _, m in rp["router_diffs"]), default=0.0),
               drops=sum(rp["drops"]), moe_calls=len(rp["drops"]))
    log(f"{tag} forced replay " + json.dumps(out))
    assert rp["rows"] == single["rows"], (tag, rp["rows"], single["rows"])
    assert rp["drops"] == single["drops"], (tag, rp["drops"],
                                            single["drops"])
    assert rp["noise_steps"] <= REPLAY_NOISE_STEPS, (tag, rp)
    assert rp["router_noise"] <= REPLAY_ROUTER_NOISE, (tag, rp)
    assert len(rp["flip_deficits"]) <= REPLAY_FLIPS, (tag, rp)
    return out


def phase_moe_mesh(api, dm, ServingEngine, prompts, before_ranks=None):
    """16. The moe family (qwen3_moe_30b_a3b, GQA) and MLA with experts
    (deepseek_v2_236b) on (1, 2) and (2, 1) meshes of two ranks sharing
    the card: serving and training against one rank, and the dry run
    against both.  ``before_ranks`` is called once the single rank's
    runs are done, before the ranks start."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.configs import ShapeCell
    from repro_torch.dist.standin import StandInMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as moe_lib
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    # the single-rank engines: the baseline tokens, decode logits, drops
    # and the experts' dequantize
    base = {}
    for arch in MOE_MESH_ARCHS:
        cfg = moe_mesh_cfg(arch)
        eng = ServingEngine(moe_mesh_model(arch, "cuda"), cfg, n_slots=4,
                            max_len=256, dtype=torch.bfloat16, device="cuda")
        with MoeDrops(moe_lib) as drops:
            base[arch] = drive(eng, prompts, dm, api, cfg,
                               f"moe_mesh_single_{arch}", prefill_rows=True)
        base[arch].update(capacity_drops=drops.summary(cfg)["decode"],
                          dequantize_ms_per_layer=dequant_ms(
                              moe_lib, eng.params, flush))
        host = {"tokens": base[arch]["tokens"],
                "prefill_logits": [r.float().cpu() for r in
                                   base[arch]["prefill_logits"]],
                "decode_logits": [{k: r.float().cpu()
                                   for k, r in rows.items()}
                                  for rows in base[arch]["decode_logits"]]}
        # the single rank replayed on its own tokens, its router choices
        # recorded: the replay the ranks are forced through
        replay = forced_replay(eng, prompts, host, moe_lib)
        host["routing"] = replay.pop("routing")
        base[arch]["replay"] = replay
        assert replay["noise"] == 0 and not replay["flip_deficits"], replay
        torch.save(host, build / f"phase16_{arch}.pt")
        del eng
        torch.cuda.empty_cache()
    t_base = time.perf_counter() - t0
    # 16c's single rank and its two-microbatch twin
    want_path = build / "phase16_params.pt"
    single_train, span = train_baseline(dm, moe_train_setup, want_path)
    log("moe train single rank " + json.dumps(single_train))
    t_train = time.perf_counter() - t0 - t_base
    if before_ranks is not None:
        before_ranks()
    card_memory("phase 16's ranks")
    try:
        ranks = mesh_lib.run_local(moe_mesh_rank, 2, prompts, str(want_path),
                                   span, backend="gloo", device="cuda",
                                   workdir=str(build))
        log(f"phase 16: single-rank engines {t_base:.1f} s, single-rank "
            f"training {t_train:.1f} s, the ranks "
            f"{time.perf_counter() - t0 - t_base - t_train:.1f} s (their "
            f"training {ranks[0]['mesh_train_s']:.1f} s)")
    finally:
        want_path.unlink(missing_ok=True)
        for arch in MOE_MESH_ARCHS:
            (build / f"phase16_{arch}.pt").unlink(missing_ok=True)
    res = {f"single_rank_{a}": {k: v for k, v in base[a].items()
                                if k not in ("tokens", "decode_logits",
                                             "prefill_logits", "replay")}
           for a in MOE_MESH_ARCHS}
    # 16a/b: tokens under the near-tie rule, launches, the gate
    for arch in MOE_MESH_ARCHS:
        one = base[arch]
        for shape in MESH_SHAPES:
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            for r, out in enumerate(ranks):
                rec = out[tag]
                # the forced replay: the single rank's tokens and router
                # choices, so only rounding is left (its ceilings measured
                # on sound runs)
                rp = rec["replay"]
                judged = judge_replay(rp, one["replay"], f"{tag} rank {r}")
                # the served tokens: until the first router choice that
                # differs (at a router near tie) the served run IS the
                # replay, so a first divergence before it is a logit near
                # tie at the replay's own noise; one after it may follow
                # from the other expert
                limit = 2 * rp["noise"]
                first, coupled, t_first = first_divergences(
                    rec["tokens"], one["tokens"], rec["admitted"])
                routed = t_first is not None and any(
                    t <= t_first for t, _ in rp["router_diffs"])
                ties = [] if routed else near_ties(
                    first, one, limit, f"{tag} rank {r}", ulps=2)
                assert rec["stats_mesh"] == {"data": shape[0],
                                             "model": shape[1]}
                assert rec["launches_per_step"] == [
                    one["launches_per_decode_step"]], rec["launches_per_step"]
                assert rec["counts"]["launches"] > 0
                assert (shape[1] == 1 or ("HLO-AG1" in rec["gate_rules"]
                                          and "HLO-CB1" in rec["gate_rules"])
                        ), rec["gate_rules"]
                assert not [f for f in rec["gate_findings"]
                            if f[0] in ("HLO-AG1", "HLO-CB1")], rec
                rec = {k: v for k, v in rec.items()
                       if k not in ("tokens", "admitted")}
                rec.update(replay=judged, near_tie_limit=limit,
                           near_ties=len(ties),
                           first_divergence_after_a_router_tie=routed,
                           coupled_divergences=coupled,
                           tokens_equal=out[tag]["tokens"] == one["tokens"],
                           single_rank=dict(
                               capacity_drops=one["capacity_drops"],
                               dequantize_ms_per_layer=one[
                                   "dequantize_ms_per_layer"],
                               decode_ms_per_step=one["decode_ms_per_step"],
                               launches_per_decode_step=one[
                                   "launches_per_decode_step"]))
                res[f"{tag}_rank{r}"] = rec
                log(f"{tag} rank {r} " + json.dumps(rec))
    # 16b's paged variant on a split latent pool: its latent pages are the
    # contiguous cache's rows bit for bit, so the (2, 1) run's tokens
    # (held above) come back exactly
    for r, out in enumerate(ranks):
        rec = dict(out["deepseek_2x1_paged_split"])
        assert rec.pop("tokens") == out["deepseek_2x1"]["tokens"], r
        assert rec["pool_rows"] == [(SPLIT_POOL_PAGES + 1) // 2], rec
        assert rec["launches_per_step"] == [
            base["deepseek"]["launches_per_decode_step"]], rec
        assert rec["counts"]["launches"] > 0
        res[f"deepseek_2x1_paged_split_rank{r}"] = rec
        log(f"deepseek_2x1_paged_split rank {r} (tokens exactly the "
            f"contiguous (2, 1) run's) " + json.dumps(rec))
    # 16c: 15a's rules
    res["train_single_rank"] = single_train
    res["largest_loss_gap"] = check_train_ranks(single_train, ranks, res,
                                                "moe mesh train")
    # 16d: the dry run's collectives against the measured ones
    predicted = {}
    traced = dryrun.trace_cell(
        moe_mesh_cfg("qwen3_moe"), ShapeCell("moe_decode", 256, 4, "decode"),
        StandInMesh({"data": 1, "model": 2}), quant="2.12")
    predicted["qwen3_moe_decode_1x2"] = collective_counts(
        OT.collective_instructions(traced["trace"]))
    for r in range(len(ranks)):
        got = res[f"qwen3_moe_1x2_rank{r}"]["collectives_per_step"]
        assert got == predicted["qwen3_moe_decode_1x2"], (r, got, predicted)
    tcfg, _, _ = moe_train_setup()
    for shape in MESH_SHAPES:
        tag = f"train_{shape[0]}x{shape[1]}"
        traced = dryrun.trace_cell(
            tcfg, ShapeCell(tag, TRAIN_S, TRAIN_B, "train"),
            StandInMesh({"data": shape[0], "model": shape[1]}))
        predicted[tag] = collective_counts(
            OT.collective_instructions(traced["trace"]))
        for r in range(len(ranks)):
            got = res[f"{tag}_rank{r}"]["collectives_per_step"]
            assert got == predicted[tag], (tag, r, got, predicted[tag])
    res["dry_run_predicted"] = predicted
    log("moe dry run predicted = measured " + json.dumps(predicted))
    t_roof = time.perf_counter()
    roof = {}
    for arch, shape in (("deepseek_v2_236b", "decode_32k"),
                        ("qwen3_moe_30b_a3b", "train_4k")):
        cell = dryrun.run_cell(arch, shape, False)
        assert cell["status"] == "ok", cell
        roof[f"{arch}|{shape}"] = dict(
            roofline=cell["roofline"],
            collectives=cell["per_device"]["collectives"],
            trace_s=cell["compile_s"])
    res["roofline_single_production_mesh"] = roof
    log("dry-run roofline on the single production mesh (16x16 = 256 "
        "cards; a model on the H100 data sheet's figures, not a "
        f"measurement; {time.perf_counter() - t_roof:.1f} s) "
        + json.dumps(roof))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 16 took {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------ recurrent on a mesh

def recurrent_mesh_cfg(arch):
    """17a's rwkv6_7b at full width, ``RWKV_MESH_DEPTH`` layers; 17b's
    zamba2_1p2b at full width, ``ZAMBA_MESH_DEPTH`` layers (two sites)."""
    from repro_torch.configs import get_config
    if arch == "rwkv":
        return dataclasses.replace(get_config("rwkv6_7b"),
                                   n_layers=RWKV_MESH_DEPTH)
    return dataclasses.replace(get_config("zamba2_1p2b"),
                               n_layers=ZAMBA_MESH_DEPTH)


def recurrent_mesh_model(arch, device):
    """17a/b's model: synthetic AP+OR weights from the seed (the same on
    every rank and in the parent)."""
    return synthetic_model(recurrent_mesh_cfg(arch),
                           torch.Generator(device=device).manual_seed(SEED),
                           torch.Generator().manual_seed(SEED), device)


def rwkv_train_setup():
    """17c's model config, optimizer config and batches: rwkv6_7b at full
    width cut to 1 layer (bf16 params, f32 moments), phase 10's schedule,
    ``RECURRENT_TRAIN_STEPS`` batches of B ``TRAIN_B`` x S ``TRAIN_S``
    from ``SyntheticCorpus``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import OptimConfig
    cfg = dataclasses.replace(get_config("rwkv6_7b"), n_layers=1)
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                      batch=TRAIN_B, seed=SEED))
    return cfg, ocfg, [data.batch_at(s)
                       for s in range(RECURRENT_TRAIN_STEPS)]


def shard_key(pqt):
    """(the whole plan's rows, cols, parts, this block's index) of a
    shard-local plan, None for a whole one: ``KernelShapes``' key for the
    shard-local (shape, M) pairs a run gave K1."""
    sh = pqt.shard
    return None if sh is None else (sh.rows, pqt.cols, sh.parts, sh.index)


HOLDINGS = ("plane_bytes", "shard_local_plans", "whole_plans", "state_bytes",
            "ring_bytes")


def holdings(eng):
    """Bytes a rank holds: the CLAQ plans' planes (and how many plans are
    shard-local), the recurrent state (rwkv ``state``/``prev_tm``/
    ``prev_cm``/``length``, Mamba2 ``conv``/``ssm``/``length``) and the
    hybrid's ring caches' k and v."""
    from repro_torch.kernels.plan import PreparedQuantizedTensor
    from repro_torch.models.layers import KVCache
    plans = [m.kernel for m in eng.params.modules()
             if isinstance(getattr(m, "kernel", None),
                           PreparedQuantizedTensor)]
    state = ring = 0
    for c in eng.cache:
        if isinstance(c, KVCache):
            ring += sum(t.numel() * t.element_size() for t in (c.k, c.v))
        else:
            state += sum(t.numel() * t.element_size() for t in c)
    return dict(zip(HOLDINGS, (
        sum(p.numel() * 4 for k in plans for g in k.groups for p in g.planes),
        sum(k.shard is not None for k in plans),
        sum(k.shard is None for k in plans), state, ring)))


def recurrent_mesh_rank(rank, world, device, prompts, want_path, span):
    """17a-c on one of the two spawned ranks: per model and mesh of
    ``MESH_SHAPES`` the served record (tokens, launch counts, the
    shard-local (shape, M) pairs, the bytes held, decode ms, peak memory,
    a decode step's collectives, the gate, a forced replay of the single
    rank's tokens), then 17c's train records."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.analysis import op_trace as OT
    from repro_torch.analysis.artifacts import decode_ops, verify_engine
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import ServingEngine
    out = {}
    for arch in RECURRENT_MESH_ARCHS:
        cfg = recurrent_mesh_cfg(arch)
        base = torch.load(REPO / "build" / f"phase17_{arch}.pt")
        whole = recurrent_mesh_model(arch, device)
        for shape in MESH_SHAPES:
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            mesh = mesh_lib.make_debug_mesh(shape, device_type="cuda")
            t0 = time.perf_counter()
            eng = ServingEngine(copy.deepcopy(whole), cfg, n_slots=4,
                                max_len=256, dtype=torch.bfloat16,
                                device=device, mesh=mesh)
            t1 = time.perf_counter()
            rep = verify_engine(eng, raise_on_error=False)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with KernelShapes(ops, shard_key) as seen:
                tokens, counts, step_launches, step_ms, admitted = \
                    mesh_serve(eng, prompts, dm)
            peak = torch.cuda.max_memory_allocated()
            t3 = time.perf_counter()
            replay = forced_replay(eng, prompts, base)
            t4 = time.perf_counter()
            colls = OT.collective_instructions(decode_ops(eng))
            out[tag] = dict(
                tokens=tokens, admitted=admitted, counts=counts,
                shard_local_m={k: sorted(v) for k, v in seen.seen.items()},
                launches_per_step=sorted(set(step_launches)),
                decode_ms_per_step=float(np.mean(step_ms)),
                decode_ms_per_step_min=float(np.min(step_ms)),
                max_memory_allocated_gb=peak / 1e9,
                collectives_per_step=collective_counts(colls),
                gate_rules=rep.rules_run,
                gate_findings=[(f.rule_id, f.severity.name, f.message[:160])
                               for f in rep.findings],
                replay=replay,
                seconds=dict(engine=t1 - t0, gate=t2 - t1, serve=t3 - t2,
                             replay=t4 - t3),
                stats_mesh=eng.stats()["mesh"], **holdings(eng))
            del eng
            torch.cuda.empty_cache()
        del whole, base
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out.update(mesh_train_rank(rank, world, device, want_path, span,
                               setup=rwkv_train_setup))
    out["mesh_train_s"] = time.perf_counter() - t0
    return out


def judge_recurrent_replay(rp, single, arch, tag):
    """Hold a rank's forced replay of the single rank's tokens (a
    recurrent family: no routing) to ``arch``'s fixed ceilings from sound
    runs: the same rows as the single rank's own replay, every row's
    logit noise at most ``RECURRENT_REPLAY_NOISE_STEPS`` bf16 steps at its
    largest logit, at most ``RECURRENT_REPLAY_FLIPS`` argmax flips.
    Returns the readings, logged."""
    out = dict(rows=rp["rows"], noise=rp["noise"],
               noise_steps=rp["noise_steps"], flips=len(rp["flip_deficits"]),
               largest_flip_deficit=max(rp["flip_deficits"], default=0.0),
               noise_steps_ceiling=RECURRENT_REPLAY_NOISE_STEPS[arch],
               flips_ceiling=RECURRENT_REPLAY_FLIPS[arch])
    log(f"{tag} forced replay " + json.dumps(out))
    assert rp["rows"] == single["rows"], (tag, rp["rows"], single["rows"])
    assert rp["noise_steps"] <= RECURRENT_REPLAY_NOISE_STEPS[arch], (tag,
                                                                     out)
    assert len(rp["flip_deficits"]) <= RECURRENT_REPLAY_FLIPS[arch], (tag,
                                                                      out)
    return out


def phase_recurrent_mesh(api, dm, ops, plan, ServingEngine, prompts, gen):
    """17. rwkv6_7b and zamba2_1p2b on (1, 2) and (2, 1) meshes of two
    ranks sharing the card: serving and training against one rank, K1 on
    every shard-local plan the ranks ran against its plain version, and
    the dry run against the ranks' collectives."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.configs import ShapeCell
    from repro_torch.dist.standin import StandInMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    # the single-rank engines: the baseline tokens, decode and prefill
    # logits, the bytes held; one whole plan of each shape, for 17's K1
    # checks on their shard-local blocks
    base, served = {}, {}
    for arch in RECURRENT_MESH_ARCHS:
        cfg = recurrent_mesh_cfg(arch)
        eng = ServingEngine(recurrent_mesh_model(arch, "cuda"), cfg,
                            n_slots=4, max_len=256, dtype=torch.bfloat16,
                            device="cuda")
        base[arch] = drive(eng, prompts, dm, api, cfg,
                           f"recurrent_mesh_single_{arch}", prefill_rows=True)
        base[arch].update(holdings(eng))
        host = {"tokens": base[arch]["tokens"],
                "prefill_logits": [r.float().cpu() for r in
                                   base[arch]["prefill_logits"]],
                "decode_logits": [{k: r.float().cpu()
                                   for k, r in rows.items()}
                                  for rows in base[arch]["decode_logits"]]}
        # the single rank replayed on its own tokens: the replay the ranks
        # are forced through
        replay = forced_replay(eng, prompts, host)
        base[arch]["replay"] = replay
        assert replay["noise"] == 0 and not replay["flip_deficits"], replay
        torch.save(host, build / f"phase17_{arch}.pt")
        served_plans(eng.params, served)
        del eng
        torch.cuda.empty_cache()
    t_base = time.perf_counter() - t0
    # 17c's single rank and its two-microbatch twin
    want_path = build / "phase17_params.pt"
    single_train, span = train_baseline(dm, rwkv_train_setup, want_path)
    log("rwkv train single rank " + json.dumps(single_train))
    t_train = time.perf_counter() - t0 - t_base
    card_memory("phase 17's ranks")
    try:
        ranks = mesh_lib.run_local(recurrent_mesh_rank, 2, prompts,
                                   str(want_path), span, backend="gloo",
                                   device="cuda", workdir=str(build))
        log(f"phase 17: single-rank engines {t_base:.1f} s, single-rank "
            f"training {t_train:.1f} s, the ranks "
            f"{time.perf_counter() - t0 - t_base - t_train:.1f} s (their "
            f"training {ranks[0]['mesh_train_s']:.1f} s)")
    finally:
        want_path.unlink(missing_ok=True)
        for arch in RECURRENT_MESH_ARCHS:
            (build / f"phase17_{arch}.pt").unlink(missing_ok=True)
    res = {f"single_rank_{a}": {k: v for k, v in base[a].items()
                                if k not in ("tokens", "decode_logits",
                                             "prefill_logits")}
           for a in RECURRENT_MESH_ARCHS}
    # the dry run's decode step of each engine: the model's collectives,
    # plus, on a data axis, the engine's one all-gather of the sampled
    # tokens (n_slots int64) before the step's host transfer
    predicted = {}
    for arch in RECURRENT_MESH_ARCHS:
        for shape in MESH_SHAPES:
            traced = dryrun.trace_cell(
                recurrent_mesh_cfg(arch),
                ShapeCell("recurrent_decode", 256, 4, "decode"),
                StandInMesh({"data": shape[0], "model": shape[1]}),
                quant="2.12")
            colls = OT.collective_instructions(traced["trace"])
            if shape[0] > 1:
                colls.append(("all-gather", 4 * 8))
            predicted[f"{arch}_decode_{shape[0]}x{shape[1]}"] = \
                collective_counts(colls)
    # 17a/b: tokens (a first divergence a near tie at the replay's fixed
    # ceiling), the forced replay, launches, the bytes held, the gate
    shard_m = {}
    for arch in RECURRENT_MESH_ARCHS:
        one = base[arch]
        for shape in MESH_SHAPES:
            tag = f"{arch}_{shape[0]}x{shape[1]}"
            want = predicted[f"{arch}_decode_{shape[0]}x{shape[1]}"]
            for r, out in enumerate(ranks):
                rec = out[tag]
                judged = judge_recurrent_replay(rec["replay"], one["replay"],
                                                arch, f"{tag} rank {r}")
                # each request's tokens equal the single rank's up to its
                # first divergence, which must be a near tie within twice
                # the replay's ceiling (in bf16 steps at the row's largest
                # logit); past it the request's recurrent state carries
                # the other token, and the replay holds the computation.
                # Until a request diverges its rows are the replay's own
                # (the same history, slot and batch; no row of a
                # recurrent step reads another), so the divergence is
                # one of the replay's flips, at the same position
                ties = near_ties(rec["tokens"], one, 0.0, f"{tag} rank {r}",
                                 ulps=2 * RECURRENT_REPLAY_NOISE_STEPS[arch])
                flips = {tuple(f) for f in rec["replay"]["flips_at"]}
                assert all((t["request"], t["position"]) in flips
                           for t in ties), (tag, r, ties, sorted(flips))
                assert rec["stats_mesh"] == {"data": shape[0],
                                             "model": shape[1]}
                assert rec["launches_per_step"] == [
                    one["launches_per_decode_step"]], rec["launches_per_step"]
                assert rec["counts"]["launches"] > 0
                assert rec["collectives_per_step"] == want, (
                    tag, r, rec["collectives_per_step"], want)
                assert (shape[1] == 1 or ("HLO-AG1" in rec["gate_rules"]
                                          and "HLO-CB1" in rec["gate_rules"])
                        ), rec["gate_rules"]
                assert not [f for f in rec["gate_findings"]
                            if f[0] in ("HLO-AG1", "HLO-CB1")], rec
                # half the planes on (1, 2) (the plans whose tiles split),
                # half the recurrent state and ring rows on (2, 1)
                if shape[1] == 2:
                    assert rec["shard_local_plans"] > 0, rec
                    assert rec["plane_bytes"] < one["plane_bytes"], rec
                    assert rec["state_bytes"] == one["state_bytes"], rec
                    assert 2 * rec["ring_bytes"] == one["ring_bytes"], rec
                else:
                    assert rec["shard_local_plans"] == 0, rec
                    assert rec["plane_bytes"] == one["plane_bytes"], rec
                    assert 2 * rec["state_bytes"] == one["state_bytes"], rec
                    assert 2 * rec["ring_bytes"] == one["ring_bytes"], rec
                for k, ms in rec["shard_local_m"].items():
                    shard_m.setdefault((arch,) + k, set()).update(ms)
                rec = {k: v for k, v in rec.items()
                       if k not in ("tokens", "admitted", "replay",
                                    "shard_local_m")}
                rec.update(replay=judged, near_ties=len(ties),
                           tokens_equal=out[tag]["tokens"] == one["tokens"],
                           dry_run_collectives=want,
                           single_rank=dict(
                               decode_ms_per_step=one["decode_ms_per_step"],
                               launches_per_decode_step=one[
                                   "launches_per_decode_step"],
                               max_memory_allocated_gb=one[
                                   "max_memory_allocated_gb"],
                               **{k: one[k] for k in HOLDINGS}))
                res[f"{tag}_rank{r}"] = rec
                log(f"{tag} rank {r} " + json.dumps(rec))
    # K1 on every shard-local plan the ranks ran, both blocks, at every M
    # they gave it, against its plain version
    local, shapes = {}, {}
    for (arch, rows, cols, parts, index), ms in sorted(shard_m.items()):
        key = (rows, cols, parts, index)
        local[key] = plan.local_plan(served[(rows, cols)], parts, index)
        shapes.setdefault(key, set()).update(ms)
    assert {k[3] for k in shapes} == {0, 1}, sorted(shapes)
    cases, max_err = phase_new_shapes(dm, ops, local, shapes, gen, "f32")
    res["shard_local_k1"] = dict(
        cases=len(cases), max_abs_err=max_err,
        checked_m={f"{r}x{c} block {i} of {p}": sorted(v)
                   for (r, c, p, i), v in sorted(shapes.items())},
        decode_cases=[{f: c[f] for f in ("shape", "block", "m", "device_ms",
                                         "library_device_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
                      for c in cases if c["m"] == 4])
    log("recurrent shard-local K1 " + json.dumps(
        {k: v for k, v in res["shard_local_k1"].items()
         if k != "decode_cases"}))
    del local, served
    torch.cuda.empty_cache()
    # 17c: 15a's rules
    res["train_single_rank"] = single_train
    res["largest_loss_gap"] = check_train_ranks(single_train, ranks, res,
                                                "rwkv mesh train")
    tcfg, _, _ = rwkv_train_setup()
    for shape in MESH_SHAPES:
        tag = f"train_{shape[0]}x{shape[1]}"
        traced = dryrun.trace_cell(
            tcfg, ShapeCell(tag, TRAIN_S, TRAIN_B, "train"),
            StandInMesh({"data": shape[0], "model": shape[1]}))
        predicted[tag] = collective_counts(
            OT.collective_instructions(traced["trace"]))
        for r in range(len(ranks)):
            got = res[f"{tag}_rank{r}"]["collectives_per_step"]
            assert got == predicted[tag], (tag, r, got, predicted[tag])
    res["dry_run_predicted"] = predicted
    log("recurrent dry run predicted = measured " + json.dumps(predicted))
    t_roof = time.perf_counter()
    roof = {}
    for arch, shape in (("rwkv6_7b", "decode_32k"),
                        ("zamba2_1p2b", "decode_32k")):
        cell = dryrun.run_cell(arch, shape, False)
        assert cell["status"] == "ok", cell
        roof[f"{arch}|{shape}"] = dict(
            roofline=cell["roofline"],
            collectives=cell["per_device"]["collectives"],
            trace_s=cell["compile_s"])
    res["roofline_single_production_mesh"] = roof
    log("dry-run roofline on the single production mesh (16x16 = 256 "
        "cards; a model on the H100 data sheet's figures, not a "
        f"measurement; the hybrid's sites and Mamba2 layers counted apart; "
        f"{time.perf_counter() - t_roof:.1f} s) " + json.dumps(roof))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 17 took {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------- encdec on a mesh

def encdec_mesh_cfg():
    """18a's seamless_m4t_medium at full width, ``ENCDEC_MESH_DEPTH``
    (encoder, decoder) layers."""
    from repro_torch.configs import get_config
    enc, dec = ENCDEC_MESH_DEPTH
    return dataclasses.replace(get_config("seamless_m4t_medium"),
                               enc_layers=enc, dec_layers=dec,
                               n_layers=enc + dec)


def encdec_mesh_model(device):
    """18a's model: synthetic AP+OR weights from the seed (the same on
    every rank and in the parent), prepared into plans."""
    from repro_torch.kernels.plan import prepare_tree
    return prepare_tree(synthetic_model(
        encdec_mesh_cfg(), torch.Generator(device=device).manual_seed(SEED),
        torch.Generator().manual_seed(SEED), device))


def encdec_train_setup():
    """18b's model config, optimizer config and batches: seamless_m4t_medium
    at full width cut to 1 encoder and 1 decoder layer (bf16 params, f32
    moments), phase 10's schedule, ``ENCDEC_TRAIN_STEPS`` batches of B
    ``TRAIN_B``: tokens of ``ENCDEC_TRAIN_S`` from ``SyntheticCorpus``
    and seeded frames of as many rows."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.optim import OptimConfig
    cfg = dataclasses.replace(get_config("seamless_m4t_medium"),
                              enc_layers=1, dec_layers=1, n_layers=2)
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=ENCDEC_TRAIN_S,
                                      batch=TRAIN_B, seed=SEED))
    host = torch.Generator().manual_seed(SEED + 18)
    return cfg, ocfg, [
        {"tokens": data.batch_at(s),
         "frames": torch.randn((TRAIN_B, ENCDEC_TRAIN_S, cfg.d_model),
                               generator=host).to(torch.bfloat16)}
        for s in range(ENCDEC_TRAIN_STEPS)]


def encdec_rows(mesh):
    """This data rank's block of 18a's ``ENCDEC_FRAMES`` rows (every row
    without a mesh)."""
    from repro_torch.dist import sharding as shd
    B = ENCDEC_FRAMES[0]
    if mesh is None:
        return slice(0, B)
    parts, index = shd.entry_block(shd.MeshAxes(mesh).dp, mesh,
                                   shd.mesh_coords(mesh))
    return slice(index * B // parts, (index + 1) * B // parts)


def encdec_generate(api, dm, model, cfg, frames, toks, mesh=None,
                    forced=None, trace_step=None):
    """``api.prefill_step`` over ``frames``/``toks`` and ``MAX_NEW``
    ``api.decode_step``s on ``mesh`` (a placed model; each data rank on
    its rows of the batch and of a placed cache, under
    ``dctx.rows_over_dp``), the launch counts set to 0 just before and
    read just after.  Each step feeds the argmax (all-gathered over
    "data": every rank holds every row's tokens), or with ``forced`` (B,
    MAX_NEW + 1) those tokens.  Returns the tokens (B rows of MAX_NEW + 1),
    this rank's logits rows (rows, MAX_NEW + 1, V) on the host, the
    counts, each decode step's synchronized ms and K1 launches, peak
    memory, and the op trace of decode step ``trace_step`` (not timed)."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    B, Ss = frames.shape[:2]
    rows = encdec_rows(mesh)
    cache = api.make_cache(cfg, B, toks.shape[1] + MAX_NEW + 1,
                           torch.bfloat16, frames.device, src_len=Ss)
    if mesh is not None:
        cache = shd.place_cache(cache, cfg, mesh)
    split = mesh is not None and rows.stop - rows.start < B
    batch = {"frames": frames[rows], "tokens": toks[rows]}
    logits, out, step_ms, step_launches, trace = [], [], [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dm)
    with torch.no_grad(), dctx.use_mesh(mesh), dctx.rows_over_dp(split):
        lg, cache = api.prefill_step(model, cfg, batch, cache)
        for j in range(MAX_NEW + 1):
            logits.append(lg.float().cpu())
            tok = lg.argmax(dim=-1)
            if split:
                tok = coll.all_gather(tok, dim=0, axis="data", mesh=mesh)
            out.append(tok.cpu())
            if j == MAX_NEW:
                break
            feed = (tok if forced is None
                    else forced[:, j].to(frames.device))[rows]

            def step(feed=feed, cache=cache):
                return api.decode_step(model, cfg, feed, cache)
            if j == trace_step:
                (lg, cache), trace = OT.capture(step, frames.device)
                continue
            before = dm.launch_count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches.append(dm.launch_count - before)
    counts = read_counts(dm)
    return dict(tokens=torch.stack(out, dim=1).tolist(),
                logits=torch.stack(logits, dim=1), counts=counts,
                step_ms=step_ms, step_launches=step_launches,
                peak=torch.cuda.max_memory_allocated(), trace=trace,
                cache_bytes={f: sum(t.numel() * t.element_size() for t in (
                    [getattr(cache, f)] if f != "self_kv" else
                    [x for c in cache.self_kv for x in (c.k, c.v)]))
                    for f in ("cross_k", "cross_v", "self_kv")})


def encdec_replay(got, base, rows):
    """A forced run's logits (``got``: this rank's rows of ``rows``,
    forced to the single rank's tokens) held to the single rank's
    (``base``): the largest |gap| (and in bf16 steps at the row's largest
    logit), the rows, and where its argmax is not the single rank's token
    (the single rank's deficit there, and (request, position))."""
    st = dict(noise=0.0, noise_steps=0.0, rows=0, flip_deficits=[],
              flips_at=[])
    for a, i in enumerate(range(rows.start, rows.stop)):
        for j in range(MAX_NEW + 1):
            row, want = got[a, j], base["logits"][i, j]
            gap = float((row - want).abs().max())
            st["noise"] = max(st["noise"], gap)
            st["noise_steps"] = max(st["noise_steps"],
                                    gap / bf16_step_at(want))
            st["rows"] += 1
            top, token = int(row.argmax()), base["tokens"][i][j]
            if top != token:
                st["flip_deficits"].append(float(want[token] - want[top]))
                st["flips_at"].append((i, j))
    return st


def encdec_holdings(model):
    """The CLAQ plans' plane bytes a rank holds, and how many plans are
    shard-local."""
    from repro_torch.kernels.plan import PreparedQuantizedTensor
    plans = [m.kernel for m in model.modules()
             if isinstance(getattr(m, "kernel", None),
                           PreparedQuantizedTensor)]
    return dict(plane_bytes=sum(p.numel() * 4 for k in plans
                                for g in k.groups for p in g.planes),
                shard_local_plans=sum(k.shard is not None for k in plans))


def encdec_mesh_rank(rank, world, device, want_path, span):
    """18a-b on one of the two spawned ranks: per mesh of ``MESH_SHAPES``
    the generation record (tokens, launches, the shard-local (shape, M)
    pairs, the bytes held, decode ms, peak memory, a decode step's
    collectives, a forced replay of the single rank's tokens), then 18b's
    train records."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.analysis import op_trace as OT
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import api
    cfg = encdec_mesh_cfg()
    base = torch.load(REPO / "build" / "phase18.pt")
    frames, toks = base["frames"].to(device), base["toks"].to(device)
    forced = torch.tensor(base["tokens"])
    whole = encdec_mesh_model(device)
    out = {}
    for shape in MESH_SHAPES:
        tag = f"encdec_{shape[0]}x{shape[1]}"
        mesh = mesh_lib.make_debug_mesh(shape, device_type="cuda")
        model = copy.deepcopy(whole)
        shd.place_model(model, cfg, mesh)
        t0 = time.perf_counter()
        with KernelShapes(ops, shard_key) as seen:
            run = encdec_generate(api, dm, model, cfg, frames, toks, mesh,
                                  trace_step=2)
        t1 = time.perf_counter()
        replay = encdec_generate(api, dm, model, cfg, frames, toks, mesh,
                                 forced=forced)
        t2 = time.perf_counter()
        rows = encdec_rows(mesh)
        out[tag] = dict(
            tokens=run["tokens"], counts=run["counts"],
            shard_local_m={k: sorted(v) for k, v in seen.seen.items()},
            launches_per_step=sorted(set(run["step_launches"])),
            decode_ms_per_step=float(np.median(run["step_ms"])),
            decode_ms_per_step_min=float(np.min(run["step_ms"])),
            max_memory_allocated_gb=run["peak"] / 1e9,
            collectives_per_step=collective_counts(
                OT.collective_instructions(run["trace"])),
            cross_bank_bytes=(run["cache_bytes"]["cross_k"]
                              + run["cache_bytes"]["cross_v"]),
            self_kv_bytes=run["cache_bytes"]["self_kv"],
            replay=encdec_replay(replay["logits"], base, rows),
            rows=[rows.start, rows.stop],
            seconds=dict(serve=t1 - t0, replay=t2 - t1),
            **encdec_holdings(model))
        del model, run, replay
        torch.cuda.empty_cache()
    del whole
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out.update(mesh_train_rank(rank, world, device, want_path, span,
                               setup=encdec_train_setup))
    out["mesh_train_s"] = time.perf_counter() - t0
    return out


def encdec_production_cells():
    """18c's production cells: ``run_cell`` of seamless_m4t_medium's
    train_4k, prefill_32k and decode_32k on the single and the multi-pod
    production mesh, and long_500k (skipped) on the single one (meta
    tensors only: run in a CPU process of its own)."""
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for multi in ((False, True) if shape != "long_500k" else (False,)):
            cell = dryrun.run_cell("seamless_m4t_medium", shape, multi)
            out[f"{shape}|{'multi' if multi else 'single'}"] = (
                {k: cell[k] for k in ("status", "reason")}
                if cell["status"] == "skipped" else
                {k: cell.get(k) for k in ("status", "error", "compile_s",
                                          "roofline", "chips")}
                | {"collectives": cell.get("per_device", {})
                   .get("collectives")})
    return out


def start_encdec_cells():
    """18c's production cells started in a CPU process of their own (a
    few minutes of host time on meta tensors, spent beside the card's
    phases): (the pool, the job)."""
    spawn = multiprocessing.get_context("spawn")
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn)
    return pool, pool.submit(encdec_production_cells)


def phase_encdec_mesh(api, dm, ops, plan, gen, cells=None):
    """18. seamless_m4t_medium on (1, 2) and (2, 1) meshes of two ranks
    sharing the card: prefill and decode through ``models.api`` over
    placed cross-attention banks and training, against one rank; K1 and
    K1e on every shard-local plan the ranks ran against their plain
    versions; the dry run's collectives against the ranks'; the
    production cells (``cells``: ``start_encdec_cells``' pool and job,
    started here when None; False leaves them out)."""
    from repro_torch.analysis import op_trace as OT
    from repro_torch.configs import ShapeCell
    from repro_torch.dist.standin import StandInMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    if cells is None:
        cells = start_encdec_cells()
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    cfg = encdec_mesh_cfg()
    B, Ss = ENCDEC_FRAMES
    frames = torch.randn((B, Ss, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(1, cfg.vocab, (B, ENCDEC_PROMPT), generator=gen,
                         device="cuda")
    # the single rank: the baseline tokens and logits, its own replay
    # (exact), the bytes held; one whole plan of each shape
    model = encdec_mesh_model("cuda")
    t_model = time.perf_counter() - t0
    one = encdec_generate(api, dm, model, cfg, frames, toks)
    own = encdec_generate(api, dm, model, cfg, frames, toks,
                          forced=torch.tensor(one["tokens"]))
    replay = encdec_replay(own["logits"], one, slice(0, B))
    assert replay["noise"] == 0 and not replay["flip_deficits"], replay
    served = {}
    served_plans(model, served)
    single = dict(decode_ms_per_step=float(np.median(one["step_ms"])),
                  decode_ms_per_step_min=float(np.min(one["step_ms"])),
                  launches_per_decode_step=sorted(set(one["step_launches"])),
                  max_memory_allocated_gb=one["peak"] / 1e9,
                  cross_bank_bytes=(one["cache_bytes"]["cross_k"]
                                    + one["cache_bytes"]["cross_v"]),
                  self_kv_bytes=one["cache_bytes"]["self_kv"],
                  counts=one["counts"], replay=replay,
                  **encdec_holdings(model))
    torch.save(dict(frames=frames.cpu(), toks=toks.cpu(),
                    tokens=one["tokens"], logits=one["logits"]),
               build / "phase18.pt")
    del model, own
    torch.cuda.empty_cache()
    t_base = time.perf_counter() - t0
    # 18b's single rank and its two-microbatch twin
    want_path = build / "phase18_params.pt"
    single_train, span = train_baseline(dm, encdec_train_setup, want_path)
    log("encdec train single rank " + json.dumps(single_train))
    t_train = time.perf_counter() - t0 - t_base
    card_memory("phase 18's ranks")
    try:
        ranks = mesh_lib.run_local(encdec_mesh_rank, 2, str(want_path), span,
                                   backend="gloo", device="cuda",
                                   workdir=str(build))
        log(f"phase 18: the single-rank model {t_model:.1f} s, single-rank "
            f"generation {t_base - t_model:.1f} s, single-rank training "
            f"{t_train:.1f} s, the ranks "
            f"{time.perf_counter() - t0 - t_base - t_train:.1f} s (their "
            f"training {ranks[0]['mesh_train_s']:.1f} s)")
    finally:
        want_path.unlink(missing_ok=True)
        (build / "phase18.pt").unlink(missing_ok=True)
    res = {"single_rank": single}
    log("encdec single rank " + json.dumps(single))
    # the single rank's record as ``near_ties`` reads it: per request its
    # tokens, the prefill row of token 0 and decode step j's row of token j
    base = dict(tokens=one["tokens"],
                prefill_logits=[one["logits"][i, 0] for i in range(B)],
                decode_logits=[{j: one["logits"][i, j]
                                for j in range(1, MAX_NEW + 1)}
                               for i in range(B)])
    # (c) the dry run of (a)'s decode step on each mesh
    predicted = {}
    for shape in MESH_SHAPES:
        traced = dryrun.trace_cell(
            cfg, ShapeCell("encdec_decode", 256, B, "decode"),
            StandInMesh({"data": shape[0], "model": shape[1]}),
            quant="2.12")
        predicted[f"decode_{shape[0]}x{shape[1]}"] = collective_counts(
            OT.collective_instructions(traced["trace"]))
    # (a): tokens (a first divergence a near tie at twice the replay's
    # ceiling and an argmax flip of the replay there), the replay under
    # its ceilings, launches, the bytes held, collectives = the dry run's
    shard_m = {}
    for shape in MESH_SHAPES:
        tag = f"encdec_{shape[0]}x{shape[1]}"
        flips = {tuple(f) for out in ranks
                 for f in out[tag]["replay"]["flips_at"]}
        for r, out in enumerate(ranks):
            rec = out[tag]
            rp = rec["replay"]
            judged = dict(rows=rp["rows"], noise=rp["noise"],
                          noise_steps=rp["noise_steps"],
                          flips=len(rp["flip_deficits"]),
                          largest_flip_deficit=max(rp["flip_deficits"],
                                                   default=0.0),
                          noise_steps_ceiling=ENCDEC_REPLAY_NOISE_STEPS,
                          flips_ceiling=ENCDEC_REPLAY_FLIPS)
            log(f"{tag} rank {r} forced replay " + json.dumps(judged))
            assert rp["rows"] == (MAX_NEW + 1) * B // shape[0], rp["rows"]
            assert rp["noise_steps"] <= ENCDEC_REPLAY_NOISE_STEPS, (tag, r,
                                                                    judged)
            assert len(rp["flip_deficits"]) <= ENCDEC_REPLAY_FLIPS, (
                tag, r, judged)
            ties = near_ties(rec["tokens"], base, 0.0, f"{tag} rank {r}",
                             ulps=2 * ENCDEC_REPLAY_NOISE_STEPS)
            assert all((t["request"], t["position"]) in flips
                       for t in ties), (tag, r, ties, sorted(flips))
            want = predicted[f"decode_{shape[0]}x{shape[1]}"]
            assert rec["collectives_per_step"] == want, (
                tag, r, rec["collectives_per_step"], want)
            assert rec["launches_per_step"] == single[
                "launches_per_decode_step"], rec["launches_per_step"]
            assert rec["counts"]["launches"] > 0
            # half the cross banks a rank on both meshes (their heads on
            # (1, 2), their rows on (2, 1)); half the planes on (1, 2)
            assert 2 * rec["cross_bank_bytes"] == single[
                "cross_bank_bytes"], rec
            if shape[1] == 2:
                assert rec["shard_local_plans"] > 0, rec
                assert rec["plane_bytes"] < single["plane_bytes"], rec
            else:
                assert rec["shard_local_plans"] == 0, rec
                assert rec["plane_bytes"] == single["plane_bytes"], rec
            for k, ms in rec["shard_local_m"].items():
                shard_m.setdefault(k, set()).update(ms)
            rec = {k: v for k, v in rec.items()
                   if k not in ("tokens", "replay", "shard_local_m")}
            rec.update(replay=judged, near_ties=len(ties),
                       tokens_equal=out[tag]["tokens"] == one["tokens"],
                       dry_run_collectives=want)
            res[f"{tag}_rank{r}"] = rec
            log(f"{tag} rank {r} " + json.dumps(rec))
    # K1 and K1e on every shard-local plan the ranks ran, both blocks, at
    # every M they gave K1, against their plain versions
    local, shapes = {}, {}
    for (rows_, cols, parts, index), ms in sorted(shard_m.items()):
        key = (rows_, cols, parts, index)
        local[key] = plan.local_plan(served[(rows_, cols)], parts, index)
        shapes.setdefault(key, set()).update(ms)
    assert {k[3] for k in shapes} == {0, 1}, sorted(shapes)
    cases, max_err = phase_new_shapes(dm, ops, local, shapes, gen, "f32")
    cases8, max_err8 = phase_new_shapes(dm, ops, local, shapes, gen, "int8")
    res["shard_local_k1"] = dict(
        cases=len(cases), cases8=len(cases8), max_abs_err=max_err,
        max_abs_err8=max_err8,
        checked_m={f"{r}x{c} block {i} of {p}": sorted(v)
                   for (r, c, p, i), v in sorted(shapes.items())},
        decode_cases=[{f: c[f] for f in ("shape", "block", "m", "act",
                                         "device_ms", "library_device_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")}
                      for c in cases + cases8 if c["m"] == B])
    log("encdec shard-local K1 " + json.dumps(
        {k: v for k, v in res["shard_local_k1"].items()
         if k != "decode_cases"}))
    del local, served
    torch.cuda.empty_cache()
    # (b): 15a's rules; the steps' collectives = the dry run's
    res["train_single_rank"] = single_train
    res["largest_loss_gap"] = check_train_ranks(single_train, ranks, res,
                                                "encdec mesh train")
    tcfg, _, _ = encdec_train_setup()
    for shape in MESH_SHAPES:
        tag = f"train_{shape[0]}x{shape[1]}"
        traced = dryrun.trace_cell(
            tcfg, ShapeCell(tag, ENCDEC_TRAIN_S, TRAIN_B, "train"),
            StandInMesh({"data": shape[0], "model": shape[1]}))
        predicted[tag] = collective_counts(
            OT.collective_instructions(traced["trace"]))
        for r in range(len(ranks)):
            got = res[f"{tag}_rank{r}"]["collectives_per_step"]
            assert got == predicted[tag], (tag, r, got, predicted[tag])
    res["dry_run_predicted"] = predicted
    log("encdec dry run predicted = measured " + json.dumps(predicted))
    # (c): the production cells
    if cells:
        t_cells = time.perf_counter()
        pool, job = cells
        cells = job.result()
        pool.shutdown()
        assert [k for k, c in cells.items() if c["status"] != "ok"] == [
            "long_500k|single"], cells
        assert cells["long_500k|single"]["status"] == "skipped", cells
        res["production_cells"] = cells
        log("encdec production cells (a model on the H100 data sheet's "
            "figures, not a measurement; waited "
            f"{time.perf_counter() - t_cells:.1f} s) " + json.dumps(cells))
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 took {res['phase_s']:.1f} s")
    return res


def phases_moe_families(api, dm, ops, ServingEngine, prompts, gen,
                        host_gen):
    """11. qwen3_moe_30b_a3b at full width (``MOE_DEPTH`` layers): routed
    experts dequantized + einsum, every other quantized matmul on K1;
    11b. deepseek_v2_236b at full width, 1 layer: MLA + moe + shared;
    then K1 and K1e against their plain versions at every (shape, M) they
    gave K1.  Returns the records."""
    from repro_torch.configs import get_config
    mcfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b"),
                               n_layers=MOE_DEPTH)
    assert (mcfg.d_model, mcfg.n_heads, mcfg.n_kv_heads, mcfg.n_experts,
            mcfg.top_k, mcfg.d_ff_expert, mcfg.vocab, mcfg.dtype) == (
        2048, 32, 4, 128, 8, 768, 151936, "bfloat16")
    moe_runs, served_new, shapes_new = phase_family(
        api, dm, ops, ServingEngine, mcfg, prompts, gen, host_gen, "qwen3_moe",
        (("contiguous", {}),))
    dcfg = dataclasses.replace(get_config("deepseek_v2_236b"), n_layers=1)
    assert (dcfg.d_model, dcfg.n_heads, dcfg.q_lora, dcfg.kv_lora,
            dcfg.rope_head_dim, dcfg.v_head_dim, dcfg.n_experts,
            dcfg.n_shared_experts, dcfg.top_k, dcfg.d_ff_expert,
            dcfg.vocab) == (5120, 128, 1536, 512, 64, 128, 160, 2, 6, 1536,
                            102400)
    ds_runs, served_d, shapes_d = phase_deepseek(api, dm, ops, ServingEngine,
                                                 dcfg, prompts, gen, host_gen)
    served_new.update(served_d)
    for k, v in shapes_d.items():
        shapes_new.setdefault(k, set()).update(v)
    assert len(shapes_new) == 10, sorted(shapes_new)
    cases, max_err = phase_new_shapes(dm, ops, served_new, shapes_new, gen,
                                      "f32")
    cases8, max_err8 = phase_new_shapes(dm, ops, served_new, shapes_new, gen,
                                        "int8")
    return dict(moe_runs=moe_runs, ds_runs=ds_runs, shapes=shapes_new,
                cases=cases, cases8=cases8, max_err=max_err,
                max_err8=max_err8)


def phases_recurrent_families(api, dm, ops, ServingEngine, prompts, gen,
                              host_gen):
    """12. rwkv6_7b at full width (``RWKV_DEPTH`` layers); 12b.
    zamba2_1p2b at full width and depth, its ring cache wrapped by a
    4200-token prompt; 12c. seamless_m4t_medium at full width and depth
    through models.api; then K1 and K1e against their plain versions at
    every (shape, M) they gave K1.  Returns the records."""
    from repro_torch.configs import get_config
    rcfg = dataclasses.replace(get_config("rwkv6_7b"), n_layers=RWKV_DEPTH)
    assert (rcfg.d_model, rcfg.n_heads, rcfg.rwkv_head_dim, rcfg.d_ff,
            rcfg.vocab, rcfg.dtype) == (4096, 64, 64, 14336, 65536,
                                        "bfloat16")
    rwkv_run, served_f, shapes_f = phase_rwkv(api, dm, ops, ServingEngine,
                                              rcfg, prompts, gen, host_gen)
    zcfg = get_config("zamba2_1p2b")
    assert (zcfg.n_layers, zcfg.n_sites, zcfg.d_model, zcfg.ssm_state,
            zcfg.attn_window, zcfg.d_ff, zcfg.dtype) == (
        38, 7, 2048, 64, 4096, 8192, "bfloat16")
    zamba_run, served_z, shapes_z = phase_zamba2(
        api, dm, ops, ServingEngine, zcfg, prompts, gen, host_gen)
    ecfg = get_config("seamless_m4t_medium")
    assert (ecfg.enc_layers, ecfg.dec_layers, ecfg.d_model, ecfg.d_ff,
            ecfg.vocab, ecfg.dtype) == (12, 12, 1024, 4096, 256224,
                                        "bfloat16")
    encdec_run, served_e, shapes_e = phase_encdec(api, dm, ops, ServingEngine,
                                                  ecfg, gen, host_gen)
    for served_x, shapes_x in ((served_z, shapes_z), (served_e, shapes_e)):
        served_f.update(served_x)
        for k, v in shapes_x.items():
            shapes_f.setdefault(k, set()).update(v)
    assert len(shapes_f) == 11, sorted(shapes_f)
    cases, max_err = phase_new_shapes(dm, ops, served_f, shapes_f, gen,
                                      "f32")
    cases8, max_err8 = phase_new_shapes(dm, ops, served_f, shapes_f, gen,
                                        "int8")
    return dict(rwkv_run=rwkv_run, zamba_run=zamba_run,
                encdec_run=encdec_run, shapes=shapes_f, cases=cases,
                cases8=cases8, max_err=max_err, max_err8=max_err8)


def without_tensors(obj):
    """``obj`` with every tensor in its dicts, lists and tuples replaced by
    None: what a side process hands back (its tensors die with it)."""
    if isinstance(obj, torch.Tensor):
        return None
    if isinstance(obj, dict):
        return {k: without_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(without_tensors(v) for v in obj)
    return obj


def side_process(phases, *args):
    """``phases`` (``phases_moe_families``, ``phases_recurrent_families``
    or ``phase_substrate``) in a process of its own, spawned beside the
    mesh phases: K1 loaded, TF32 off, generators from the seed and the
    phase's name.  Returns its record without tensors."""
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cuda_build, ops
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine, SpecConfig
    cuda_build.load("dequant_matmul.cu")
    seed = SEED + sum(map(ord, phases.__name__))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    if phases is phase_substrate:
        res = phase_substrate(api, dm, ops, ServingEngine, SpecConfig, gen)
    else:
        res = phases(api, dm, ops, ServingEngine, *args, gen,
                     torch.Generator().manual_seed(seed))
    log(f"{phases.__name__} took {time.perf_counter() - t0:.1f} s (in a "
        "process of its own, beside the mesh phases)")
    out = without_tensors(res)
    del res
    gc.collect()
    torch.cuda.empty_cache()     # the worker may take the next phases
    return out


def main() -> int:
    if not __debug__:
        print("chip_smoke: run without -O; its checks are asserts",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cuda_build, ops, plan, ref
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.models import api
    from repro_torch.models.modules import module_tensors
    from repro_torch import serve as serve_mod
    from repro_torch.serve import ServingEngine, SpecConfig

    # 1. device
    t_start = time.perf_counter()
    lap_at = [t_start]

    def lap(what):
        """Log the seconds since the previous lap: the phases just run."""
        now = time.perf_counter()
        log(f"{what} took {now - lap_at[0]:.1f} s")
        lap_at[0] = now
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    host_gen = torch.Generator().manual_seed(SEED)

    # 2. build
    built = cuda_build.load("dequant_matmul.cu")
    log(f"built {built.path.name} in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())
    lap("phases 1-2")

    # 3. small-input reference (card vs CPU): dense, moe, moe + MLA, and
    # a dense use_mla model (its chunked prefill and speculation too)
    small = dataclasses.replace(get_smoke_config("llama1_7b"), vocab=128)
    phase_small_reference(api, ServingEngine, small, gen, host_gen)
    for arch in ("qwen3_moe_30b_a3b", "deepseek_v2_236b"):
        phase_small_reference(api, ServingEngine, dataclasses.replace(
            get_smoke_config(arch), vocab=128), gen, host_gen, tag=arch)
    small_mla = dataclasses.replace(small, **MLA_SMALL)
    phase_small_mla(api, ServingEngine, SpecConfig, small_mla,
                    phase_small_reference(api, ServingEngine, small_mla, gen,
                                          host_gen, tag="dense use_mla"))
    lap("phase 3")

    # 4. full-width serving
    full = get_config("llama1_7b")
    assert (full.n_layers, full.d_model, full.d_ff, full.dtype) == (
        32, 4096, 11008, "bfloat16")
    cfg = dataclasses.replace(full, n_layers=SERVE_DEPTH)
    serve, model, prompts = phase_serve(api, dm, ServingEngine,
                                        module_tensors, cfg, gen, host_gen)
    lap("phase 4")

    # 4b. the same target served speculatively, with a synthetic draft
    spec, draft, limit = phase_spec_serve(api, dm, ServingEngine, SpecConfig,
                                          cfg, model, prompts, serve)
    spec_self = self_draft(api, dm, ServingEngine, SpecConfig, cfg, model,
                           prompts, serve, limit, "spec_self_serve")
    lap("phase 4b")

    # 4c. the same model from a page pool: fp, int8, shared prefixes,
    # speculation
    paged = phase_paged_serve(api, dm, ServingEngine, SpecConfig, cfg, model,
                              prompts, serve, spec, spec_self, draft, limit,
                              host_gen)
    lap("phase 4c")

    # 9. the control plane: preempt/resume, guards and faults, chunked
    # prefill, an overload storm under the SLO controller, the wall clock
    control = phase_control_plane(api, dm, serve_mod, cfg, model, draft,
                                  prompts, serve, limit, host_gen)
    del draft
    torch.cuda.empty_cache()
    runs9 = {"preempt_resume": control["preempt_resume"],
             "guards_faults": control["guards_faults"],
             "chunked_monolithic": control["chunked"]["monolithic"],
             "chunked": control["chunked"]["chunked"],
             "storm_replay": control["storm"]["replay_0"],
             "storm_replay_again": control["storm"]["replay_1"],
             "storm_wall_clock": control["storm"]["wall_clock"]}
    m9 = set().union(*(r["kernel_m"] for r in runs9.values()))
    assert {1, 4 * (GAMMA // 2 + 1)} <= m9, sorted(m9)
    lap("phase 9")

    # 5. kernel vs plain version at the shapes the serve phase ran, on the
    # served model's first plan of each matrix shape (the "aligned" cases
    # at M = n_slots are the speculative draft's plan); then at the M
    # values only the new phases gave it (the verify's n_slots *
    # (gamma+1), new prefill shapes)
    served = {}
    for m in quantized_modules(model):
        served.setdefault(tuple(m.kernel.shape), m.kernel)
    assert sorted(served) == sorted(LLAMA_SHAPES), sorted(served)
    cases, max_err = phase_kernels(dm, ops, plan, ref, served,
                                   serve["kernel_m"], gen, host_gen)
    new_m = sorted(set(spec["kernel_m"]).union(
        spec_self["kernel_m"], *(r["kernel_m"] for r in paged.values()))
        - set(serve["kernel_m"]))
    log(f"kernel checks at the new phases' M: {new_m}")
    cases_new, max_err_new = phase_kernels(dm, ops, plan, ref, served,
                                           new_m, gen, host_gen)
    max_err = max(max_err, max_err_new)
    # the M values only phase 9 gave K1, on its bf16 plans
    new_m9 = sorted(m9 - set(serve["kernel_m"]) - set(new_m))
    log(f"kernel checks at phase 9's M: {new_m9}")
    cases_9, max_err_9 = phase_kernels(
        dm, ops, plan, ref, served, new_m9, gen, host_gen,
        modes=("aligned", "gathered"), dtypes=(torch.bfloat16,))
    max_err = max(max_err, max_err_9)
    lap("phase 5")

    # 6. the same model and prompts with int8 activations (K1e)
    serve8 = phase_serve_int8(api, dm, ServingEngine, cfg, model, prompts)
    lap("phase 6")
    # 18c's production cells: host work on meta tensors, beside the rest
    # (after phases 5 and 6, whose eager timings read the host)
    encdec_cells = start_encdec_cells()

    # 13. the contract gate on the card over phase 4's model, contiguous
    # and on int8 pages (the moe, rwkv and hybrid engines get theirs in
    # phases 11, 12 and 12b), and its refusal of a violating step
    t13 = time.perf_counter()
    contracts = {
        "llama1_7b": contract_gate(ServingEngine, cfg, model, "llama1_7b"),
        "llama1_7b_paged_int8": contract_gate(
            ServingEngine, cfg, model, "llama1_7b_paged_int8",
            kv_layout="paged", page_size=PAGE_SIZE, kv_dtype="int8"),
        "refusal": contract_refusal(api, ServingEngine, small)}
    gate_s = time.perf_counter() - t13
    lap("phase 13")

    # 10. train llama1_7b at full width (QUANT_DEPTH layers), checkpoint
    # asynchronously mid-run, restore into a fresh state, resume
    train, trained = phase_train(api, cfg)
    lap("phase 10")
    # phases 11-11b, 12-12c and 10b on two spawned workers, and the CPU's
    # side of phase 8's card-vs-CPU matrix on a third, beside the mesh
    # phases (their ranks leave the host's other cores and most of the
    # card idle); the card's phases end before phase 16's ranks start, the
    # CPU's before phase 7's kernel timings
    spawn = multiprocessing.get_context("spawn")
    side = concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn)
    moe_job = side.submit(side_process, phases_moe_families, prompts)
    families_job = side.submit(side_process, phases_recurrent_families,
                               prompts)
    substrate_job = side.submit(side_process, phase_substrate)
    cpu_side = concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn)
    card_vs_cpu_inputs = start_card_vs_cpu(cpu_side, trained)

    # 14a. phase 4's model and prompts on a one-rank nccl mesh
    mesh_1x1 = phase_mesh_one_rank(api, dm, ServingEngine, cfg, model,
                                   prompts, serve)
    del model
    torch.cuda.empty_cache()
    # 14b-d. two ranks sharing the card (meshes (1, 2), (2, 1)), the
    # shard-local K1/K1e, the row-sharded quantizer
    dist_runs = phase_distribution(api, dm, ops, plan, ServingEngine,
                                   prompts, gen, host_gen)
    lap("phase 14")

    # 15. training on (1, 2) and (2, 1) meshes of two ranks sharing the
    # card, held to one rank; the dry run's collectives against 14b's and
    # 15a's measured ones; the production mesh's roofline
    mesh_train_runs = phase_mesh_train(dm, dist_runs)
    lap("phase 15")

    # phases 11-11b (deepseek's engine holds 18.5 GB) end before phase 16
    moe_fam = moe_job.result()
    lap("the wait for phases 11-11b")

    # phases 12-12c and 10b end before phase 16's ranks start: its (2, 1)
    # ranks train with ~31.5 GB each, and a side phase still running beside
    # them ran the card out of memory; the side workers then exit
    side_res = {}

    def side_phases_done():
        t_wait = time.perf_counter()
        side_res.update(families=families_job.result(),
                        substrate=substrate_job.result())
        side.shutdown()
        log("the wait for phases 12-12c and 10b (before phase 16's ranks) "
            f"took {time.perf_counter() - t_wait:.1f} s")

    # 16. the moe family and MLA with experts on (1, 2) and (2, 1) meshes
    # of two ranks sharing the card: serving and training held to one
    # rank, the dry run's collectives to the measured ones
    moe_mesh = phase_moe_mesh(api, dm, ServingEngine, prompts,
                              before_ranks=side_phases_done)
    lap("phase 16")

    # 17. rwkv6_7b and zamba2_1p2b on (1, 2) and (2, 1) meshes of two
    # ranks sharing the card: serving (a forced replay of one rank's
    # tokens) and rwkv training held to one rank, K1 on every shard-local
    # plan they ran, the dry run's collectives to the measured ones
    recurrent_mesh = phase_recurrent_mesh(api, dm, ops, plan, ServingEngine,
                                          prompts, gen)
    max_err = max(max_err, recurrent_mesh["shard_local_k1"]["max_abs_err"])
    lap("phase 17")

    # 18. seamless_m4t_medium on (1, 2) and (2, 1) meshes of two ranks
    # sharing the card: prefill and decode through models.api over placed
    # cross-attention banks, and training, held to one rank; K1 and K1e on
    # every shard-local plan they ran; the dry run's collectives to the
    # measured ones; the production cells
    encdec_mesh = phase_encdec_mesh(api, dm, ops, plan, gen, encdec_cells)
    max_err = max(max_err, encdec_mesh["shard_local_k1"]["max_abs_err"])
    lap("phase 18")
    rec_fam, substrate = side_res["families"], side_res["substrate"]
    card_vs_cpu_inputs[2].result()
    cpu_side.shutdown()
    lap("the wait for phase 8's CPU side")
    moe_runs, ds_runs = moe_fam["moe_runs"], moe_fam["ds_runs"]
    rwkv_run, zamba_run, encdec_run = (rec_fam["rwkv_run"],
                                       rec_fam["zamba_run"],
                                       rec_fam["encdec_run"])
    shapes_new, shapes_f = moe_fam["shapes"], rec_fam["shapes"]
    cases_ns, cases8_ns = moe_fam["cases"], moe_fam["cases8"]
    cases_fam, cases8_fam = rec_fam["cases"], rec_fam["cases8"]
    max_err = max(max_err, substrate["plan_max_abs_err"], moe_fam["max_err"],
                  rec_fam["max_err"])

    # 7. K1e vs plain version at every M phase 6 gave it
    cases8, max_err8 = phase_kernels(dm, ops, plan, ref, served,
                                     serve8["kernel_m"], gen, host_gen,
                                     act="int8")
    max_err8 = max(max_err8, moe_fam["max_err8"], rec_fam["max_err8"],
                   encdec_mesh["shard_local_k1"]["max_abs_err8"])
    torch.cuda.empty_cache()
    lap("phase 7")

    # K1 and K1e at the M values only 14f's split prefills gave them (a
    # data rank's Bb / 2 rows x bucket), on phase 4's bf16 plans
    m14f = sorted(set(dist_runs["split_pool_m"]) - set(serve["kernel_m"])
                  - set(new_m) - set(new_m9))
    m14f8 = sorted(set(dist_runs["split_pool_m"]) - set(serve8["kernel_m"]))
    log(f"K1 / K1e checks at 14f's shard-local prefill M: {m14f} / {m14f8}")
    cases_14f, err_14f = phase_kernels(
        dm, ops, plan, ref, served, m14f, gen, host_gen,
        modes=("aligned", "gathered"), dtypes=(torch.bfloat16,))
    cases8_14f, err8_14f = phase_kernels(
        dm, ops, plan, ref, served, m14f8, gen, host_gen, act="int8",
        modes=("aligned", "gathered"), dtypes=(torch.bfloat16,))
    max_err, max_err8 = max(max_err, err_14f), max(max_err8, err8_14f)
    lap("the 14f M checks")

    contracts.update(qwen3_moe=moe_runs["contiguous"]["contracts"],
                     rwkv6_7b=rwkv_run["contracts"],
                     zamba2_1p2b=zamba_run["contracts"])
    gate_s += sum(c["gate_s"] for k, c in contracts.items()
                  if k.startswith(("qwen3", "rwkv", "zamba")))
    log("contracts " + json.dumps({
        "engines": {k: {f: c[f] for f in ("rules_run", "findings",
                                          "transfers", "moved_leaves")}
                    for k, c in contracts.items() if k != "refusal"},
        "refusal": contracts["refusal"], "phase_s": gate_s}))

    # 8. quantize the trained model's target + draft on the card, their
    # perplexities through K1, then serve with int8 activations, vanilla
    # and speculative
    qserve = phase_quantize_serve(api, dm, ServingEngine, SpecConfig, cfg,
                                  prompts, trained, card_vs_cpu_inputs)
    del trained, card_vs_cpu_inputs
    lap("phase 8")

    # 7b. K1e at the M values only phase 8's speculation gave it (the
    # verify's n_slots * (gamma+1), its prefill shapes; phase 7's
    # "aligned" cases at M = n_slots are its draft's plan)
    new_m8 = sorted(set(qserve["spec"]["kernel_m"]) - set(serve8["kernel_m"]))
    log(f"K1e checks at phase 8's speculative M: {new_m8}")
    cases8_new, max_err8_new = phase_kernels(dm, ops, plan, ref, served,
                                             new_m8, gen, host_gen,
                                             act="int8")
    max_err8 = max(max_err8, max_err8_new)
    # and at phase 9's M values (K1e on the same bf16 plans)
    new_m89 = sorted(m9 - set(serve8["kernel_m"]) - set(new_m8))
    log(f"K1e checks at phase 9's M: {new_m89}")
    cases8_9, max_err8_9 = phase_kernels(
        dm, ops, plan, ref, served, new_m89, gen, host_gen, act="int8",
        modes=("aligned", "gathered"), dtypes=(torch.bfloat16,))
    max_err8 = max(max_err8, max_err8_9)
    # K1 at the M only phase 8's perplexity gave it (B * S of an eval
    # batch), on every mode, f32 and bf16
    m10 = sorted(set(qserve["eval_m"]) - set(serve["kernel_m"]) - set(new_m)
                 - set(new_m9))
    log(f"kernel checks at the quantized eval's M: {m10}")
    cases_10, max_err_10 = phase_kernels(dm, ops, plan, ref, served, m10,
                                         gen, host_gen)
    max_err = max(max_err, max_err_10)
    del served
    torch.cuda.empty_cache()
    lap("phase 7b and the M = 2048 checks")

    def record(name, replaces, run, case, err, case_cases, what):
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/dequant_matmul.cu",
            "replaces": replaces,
            "launches": run[what],
            "max_abs_err": err,
            "ms": case["ms"],
            "device_ms": case["device_ms"],
            "host_us_per_call": case["host_us_per_call"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "library_device_ms": case["library_device_ms"],
            "timed_case": f"11008x4096 M={run['decode_m']} (decode) "
                          "gathered bf16, 3-launch chain",
            "checked_m": run["kernel_m"],
            "checked_cases": len(case_cases),
        }

    def main_case(cs, m):
        return next(c for c in cs if c["shape"] == "11008x4096"
                    and c["m"] == m and c["x_mode"] == "gathered"
                    and c["dtype"] == "bfloat16")

    kernels = [
        record("dequant_matmul", "src/repro/kernels/dequant_matmul.py:92",
               serve, main_case(cases, serve["decode_m"]), max_err,
               cases + cases_new + cases_9 + cases_10, "main_path_launches"),
        record("dequant_matmul_int8",
               "src/repro/kernels/dequant_matmul.py:160", serve8,
               main_case(cases8, serve8["decode_m"]), max_err8,
               cases8 + cases8_new + cases8_9, "main_path_int8_launches"),
    ]
    kernels[0]["checked_m"] = sorted(set(serve["kernel_m"]) | set(new_m)
                                     | set(new_m9) | set(m10) | set(m14f))
    kernels[1]["checked_m"] = sorted(set(serve8["kernel_m"]) | set(new_m8)
                                     | set(new_m89) | set(m14f8))
    kernels[0]["checked_cases"] += len(cases_14f)
    kernels[1]["checked_cases"] += len(cases8_14f)
    for k in kernels:
        assert set(dist_runs["split_pool_m"]) <= set(k["checked_m"]), k
    assert set(qserve["spec"]["kernel_m"]) <= set(kernels[1]["checked_m"])
    assert set(spec["kernel_m"]) <= set(kernels[0]["checked_m"])
    assert m9 <= set(kernels[0]["checked_m"])
    assert set(qserve["eval_m"]) <= set(kernels[0]["checked_m"])
    assert m9 <= set(kernels[1]["checked_m"])

    def split(run):
        return dict(launches=run["main_path_launches"],
                    aligned=run["main_path_aligned_launches"],
                    gathered=run["main_path_gathered_launches"])

    kernels[0]["launches_by_path"] = dict(
        spec_serve=split(spec), spec_self_serve=split(spec_self),
        **{tag: split(run) for tag, run in paged.items()},
        **{tag: {k: run[k] for k in ("launches", "aligned", "gathered")}
           for tag, run in runs9.items()},
        quantized_eval={k: qserve["eval_counts"][k]
                        for k in ("launches", "aligned", "gathered")},
        **{f"substrate_{tag}": {k: run[k] for k in ("launches", "aligned",
                                                    "gathered")}
           for tag, run in substrate["launches"].items()})
    kernels[0]["m2048_cases"] = [
        {k: c[k] for k in ("shape", "x_mode", "dtype", "device_ms",
                           "library_device_ms", "bound_ms", "max_abs_err")}
        for c in cases_10]
    kernels[0]["substrate_plan_launches_checked"] = substrate[
        "plan_launches_checked"]
    new_paths = dict(qwen3_moe=split(moe_runs["contiguous"]),
                     **{f"deepseek_{w}": split(r) for w, r in ds_runs.items()})
    kernels[0]["launches_by_path"].update(new_paths)
    kernels[0]["launches_by_path"].update(
        rwkv=split(rwkv_run), rwkv_batch1=dict(
            launches=rwkv_run["batch1_launches"]),
        rwkv_preempt_resume={k: rwkv_run["preempt_resume"][k] for k in (
            "launches", "aligned", "gathered")},
        zamba2=split(zamba_run), zamba2_batch1=dict(
            launches=zamba_run["batch1_launches"]),
        zamba2_preempt_resume={k: zamba_run["preempt_resume"][k] for k in (
            "launches", "aligned", "gathered")},
        zamba2_ring={k: zamba_run["ring"][k] for k in (
            "launches", "aligned", "gathered")},
        seamless={k: encdec_run[k] for k in ("launches", "aligned",
                                             "gathered")},
        mesh_1x1=split(mesh_1x1),
        mesh_single_rank=dict(launches=dist_runs["single_rank"][
            "main_path_launches"]),
        **{tag: {k: v for k, v in run["counts"].items() if k != "int8"}
           for tag, run in dist_runs.items()
           if tag.startswith(("mesh_", "split_pool_")) and "counts" in run},
        **{f"moe_mesh_single_{a}": split(moe_mesh[f"single_rank_{a}"])
           for a in MOE_MESH_ARCHS},
        **{f"moe_mesh_{tag}": {k: v for k, v in run["counts"].items()
                               if k != "int8"}
           for tag, run in moe_mesh.items()
           if tag.startswith(MOE_MESH_ARCHS) and "counts" in run},
        **{f"recurrent_mesh_single_{a}": split(
            recurrent_mesh[f"single_rank_{a}"])
           for a in RECURRENT_MESH_ARCHS},
        **{f"recurrent_mesh_{tag}": {k: v for k, v in run["counts"].items()
                                     if k != "int8"}
           for tag, run in recurrent_mesh.items()
           if tag.startswith(RECURRENT_MESH_ARCHS) and "counts" in run},
        encdec_mesh_single_rank=encdec_mesh["single_rank"]["counts"],
        **{f"encdec_mesh_{tag[len('encdec_'):]}": {
            k: v for k, v in run["counts"].items() if k != "int8"}
           for tag, run in encdec_mesh.items()
           if tag.startswith("encdec_") and "counts" in run})
    kernels[0]["shard_local"] = dist_runs["shard_local"]
    kernels[0]["shard_local_recurrent"] = recurrent_mesh["shard_local_k1"]
    kernels[0]["checked_cases"] += recurrent_mesh["shard_local_k1"]["cases"]
    kernels[0]["shard_local_encdec"] = encdec_mesh["shard_local_k1"]
    kernels[0]["checked_cases"] += encdec_mesh["shard_local_k1"]["cases"]
    kernels[1]["checked_cases"] += encdec_mesh["shard_local_k1"]["cases8"]
    # phase 15's paths train in fp: no K1 or K1e launch, counted
    fp_training = dict(
        note="phases 15, 16c, 17c and 18b train in fp: no quantized "
             "matmul, no launch",
        **{tag: run["k1_launches"] for tag, run in mesh_train_runs.items()
           if isinstance(run, dict) and "k1_launches" in run},
        **{f"moe_{tag}": run["k1_launches"] for tag, run in moe_mesh.items()
           if isinstance(run, dict) and "k1_launches" in run},
        **{f"rwkv_{tag}": run["k1_launches"]
           for tag, run in recurrent_mesh.items()
           if isinstance(run, dict) and "k1_launches" in run},
        **{f"encdec_{tag}": run["k1_launches"]
           for tag, run in encdec_mesh.items()
           if isinstance(run, dict) and "k1_launches" in run})
    kernels[0]["launches_fp_training"] = fp_training
    kernels[1]["launches_fp_training"] = fp_training
    checked_new = {f"{r}x{c}": sorted(v) for (r, c), v in
                   sorted(shapes_new.items())}
    checked_fam = {f"{r}x{c}": sorted(v) for (r, c), v in
                   sorted(shapes_f.items())}
    for k, cs in ((kernels[0], cases_ns + cases_fam),
                  (kernels[1], cases8_ns + cases8_fam)):
        k["checked_cases"] += len(cs)
        k["new_shapes_checked_m"] = {**checked_new, **checked_fam}
        k["new_shape_decode_cases"] = [
            {f: c[f] for f in ("shape", "m", "device_ms", "library_device_ms",
                               "bound_ms", "bound_by", "max_abs_err")}
            for c in cs if c["m"] == 4]
    kernels[1]["launches_quantize_serve"] = qserve["main_path_int8_launches"]
    kernels[1]["launches_by_path"] = dict(
        quantize_serve=split(qserve), quantize_spec_serve=split(qserve["spec"]))
    assert kernels[0]["launches"] > 0, "the main path never launched K1"
    assert kernels[1]["launches"] > 0, "the int8 path never launched K1e"
    assert kernels[1]["launches_quantize_serve"] > 0
    for path in (kernels[0]["launches_by_path"],
                 kernels[1]["launches_by_path"]):
        assert all(v["launches"] > 0 for v in path.values()), path
    assert spec["main_path_aligned_launches"] > 0
    assert spec["main_path_gathered_launches"] > 0
    assert qserve["spec"]["main_path_int8_launches"] > 0
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
