#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA
H100 and hold its CUDA kernel against its plain version.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: K1 (``csrc/dequant_matmul.cu`` and its per-bit-width sources,
     one nvcc each, in parallel) from the checkout's sources;
  3. reference check on a small input: the same synthetic CLAQ model
     served on the card (kernel) and on the CPU (plain version);
  4. serve llama1_7b at full width (32 layers, d 4096, bf16) with
     synthetic CLAQ AP+OR weights through ``ServingEngine``: 8 requests,
     4 slots, 16 new tokens each, with the kernel's launch counts and a
     ``torch.profiler`` reading of two decode steps (device-busy share,
     top kernels by device time);
  5. kernel vs plain version on the card at every (M, N, K) the serve
     phase gave K1: M = n_slots for decode and Bb * bucket for each
     prefill shape it ran, at the three matrix shapes of llama1_7b, on
     the served model's own plans (a 2/3/4-bit gathered chain through
     ``acc``, with outliers; also pre-gathered as "blocked") and on a
     single-width plan ("aligned"), f32 and bf16; times beside the bound
     and a ``torch.matmul`` yardstick on the pre-dequantized weight: eager
     (``ms``, host enqueue included), device time from a CUDA graph of the
     chain (``device_ms``) and the wrapper's host time per call;
  6. the phase-4 model served again with int8 activations
     (``ServingEngine(act_dtype="int8")``, K1e), same prompts, with the
     int8 launch counts;
  7. K1e (int8 x, the (M, 1) scale on the last launch) vs its plain
     version at every M phase 6 gave it, as in phase 5, and within
     ``ref_act_int8_bound`` of the f32-activation kernel;
  8. quantize, then serve: a random-init llama1_7b at full width (cut in
     depth to ``QUANT_DEPTH`` layers) calibrated on synthetic tokens and
     CLAQ-quantized on the card (``launch.quantize.claq_quantize``, the
     recipe of ``launch.serve --bits 2.2``), one 4096x4096 matrix also
     quantized on the CPU and held against the card's (with a full-rank
     Hessian; calibration Hessians are reported), then served with int8
     activations.
It prints a JSON line of kernel records, then, as its last line,
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import copy
import dataclasses
import json
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
QUANT_DEPTH = 2                    # layers of the phase-8 model
PROMPT_LENS = (5, 17, 29, 42, 56, 70, 85, 100)
MAX_NEW = 16
PROFILE_STEP = 8                   # two decode steps from the 9th on run
#                                    under the profiler, once every prompt
#                                    is admitted (no prefill in the window)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- weights

def synthetic_qt(rows, cols, gen, host_gen, device, bits=None, k_max=3):
    """A CLAQ AP+OR tensor built through the port's build_quantized_tensor
    from seeded parts: random codes, per-column sorted codebooks scaled by
    cols^-0.5, column bits ~90 % 2 / 5 % 3 / 5 % 4 (or all ``bits``), and
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
    cb = torch.sort(torch.randn((cols, 16), generator=gen, device=device),
                    dim=1).values * cols ** -0.5
    cb = torch.where(torch.arange(16, device=device)[None, :]
                     < levels[:, None], cb, float("inf"))
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
    """Dense-family Transformer whose block matmuls are synthetic CLAQ
    tensors; embedding, norms and lm_head stay dense."""
    from repro_torch.models import layers as L
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as tf
    D, H, KH, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    dt = tf.torch_dtype(cfg)

    def q(out_dim, in_dim):
        return M.Dense(make_qt(out_dim, in_dim, gen, host_gen, device))

    blocks = []
    for _ in range(cfg.n_layers):
        attn = L.Attention(q(H * hd, D), q(KH * hd, D), q(KH * hd, D),
                           q(D, H * hd))
        mlp = L.SwiGLU(q(F, D), q(F, D), q(D, F))
        blocks.append(tf.Block(M.norm_scale_init(D, device=device),
                               M.norm_scale_init(D, device=device), attn,
                               mlp))
    emb = M.embed_init(gen, cfg.vocab, D, dt, device)
    head = M.dense_init(gen, D, cfg.vocab, dtype=dt, device=device)
    return tf.Transformer(emb, blocks, M.norm_scale_init(D, device=device),
                          head)


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
                  act="f32"):
    """Kernel vs plain version at every M of ``main_ms`` and each of
    llama1_7b's matrix shapes; ``served`` maps (out, in) to a plan of the
    served model.  act="int8" runs K1e: x quantized per token, int8 x in
    every launch and the scale on the last (gather="kernel") or after the
    chain (blocked), also held within ``ref_act_int8_bound`` of the
    f32-activation kernel.  Returns the records and the largest error."""
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
                for dtype in (torch.float32, torch.bfloat16):
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


def phase_small_reference(api, ServingEngine, cfg, gen, host_gen):
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
    log(f"small-model reference: prefill + 3 decode steps, logits max "
        f"|gpu - cpu| = {err:.3e}"
        f"; greedy tokens gpu {out['gpu']} cpu {out['cpu']}")


def drive(eng, prompts, dm, api, cfg, tag):
    """Serve ``prompts`` through ``eng`` (all admitted as slots free up,
    ``MAX_NEW`` tokens each), with the launch counts set to 0 just before
    and read just after.  Asserts every request finished, one launch per
    distinct bit-width per matmul per step or prefill call, and no plain
    version; returns the record."""
    qmods = quantized_modules(eng.params)
    launches_per_matmul = sum(len(m.kernel.groups) for m in qmods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm.launch_count = dm.int8_launch_count = dm.plain_count = 0
    prefill_s, decode_s, decode_launches, prefill_calls = [], [], [], 0
    order = []
    pending = list(prompts)
    prof, prof_s, steps = None, None, 0
    t_run = time.perf_counter()
    while pending or eng.active:
        if pending and eng.free:
            batch = [pending.pop(0)
                     for _ in range(min(len(pending), len(eng.free)))]
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
        t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches, int8_launches = dm.launch_count, dm.int8_launch_count
    main_plain = dm.plain_count
    peak = torch.cuda.max_memory_allocated()

    fin = eng.take_finished()
    assert sorted(fin) == sorted(order) and len(fin) == len(prompts)
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == MAX_NEW for u in order)
    assert main_plain == 0, "the main path ran the plain version on the card"
    assert set(decode_launches) == {launches_per_matmul}, \
        (set(decode_launches), launches_per_matmul)
    assert launches == launches_per_matmul * (prefill_calls
                                              + len(decode_launches))
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
    # decode runs every slot; a prefill of shape (Bb, bucket) runs Bb*bucket
    kernel_m = sorted({eng.n_slots} | {b * n for b, n
                                       in eng.bucketing.stats.per_shape})
    res = dict(act_dtype=stats["act_dtype"], requests=len(order),
               new_tokens=tokens, prefill_calls=prefill_calls,
               prefill_ms=sum(prefill_s) * 1e3, decode_steps=len(decode_s),
               decode_ms_per_step=float(np.mean(decode_s)) * 1e3,
               decode_ms_per_step_min=float(np.min(decode_s)) * 1e3,
               tokens_per_s=tokens / run_s, run_s=run_s,
               launches_per_decode_step=launches_per_matmul,
               launches_per_prefill_call=launches_per_matmul,
               main_path_launches=launches,
               main_path_int8_launches=int8_launches,
               max_memory_allocated_gb=peak / 1e9,
               prefill_shapes=stats["prefill_traces"],
               prefill_batch_bucket=sorted(eng.bucketing.stats.per_shape),
               decode_m=eng.n_slots, kernel_m=kernel_m,
               profile_two_decode_steps=profile)
    log(tag + " " + json.dumps(res))
    log("sample tokens: " + str([fin[u].tokens[:8] for u in order[:2]]))
    return res


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
    assert len(qmods) == 7 * cfg.n_layers == 224, len(qmods)
    packed = sum(s.packed.numel() * 4 for m in qmods
                 for s in m.kernel.stripes)
    eff = np.mean([m.kernel.effective_bits() for m in qmods])
    log(f"built 224 CLAQ matrices in {time.perf_counter() - t0:.1f} s: "
        f"packed codes {packed / 1e9:.3f} GB, mean effective bits "
        f"{eff:.3f}")

    t0 = time.perf_counter()
    eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"engine init (plans for 224 matrices): "
        f"{time.perf_counter() - t0:.1f} s")
    assert all(t.is_cuda for t in module_tensors(model))
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=host_gen).tolist()
               for n in PROMPT_LENS]
    return drive(eng, prompts, dm, api, cfg, "serve"), model, prompts


def phase_serve_int8(api, dm, ServingEngine, cfg, model, prompts):
    """The phase-4 model (its plans already prepared) served again with
    int8 activations on the same prompts."""
    eng = ServingEngine(model, cfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, act_dtype="int8",
                        device="cuda")
    return drive(eng, prompts, dm, api, cfg, "serve_int8")


def codes_of(qt):
    """Codes of a QuantizedTensor, (rows, cols) in original column order
    (the order GPTQ quantized them in)."""
    from repro_torch.core import packing
    c = torch.cat([packing.unpack_codes(s.packed, s.bits, qt.rows)
                   for s in qt.stripes], dim=1)
    out = torch.empty_like(c)
    out[:, qt.col_perm.long()] = c
    return out


def card_vs_cpu(claq_lib, W, H, qcfg):
    """Quantize the same W and H on the card and on the CPU: plans must be
    equal; returns the share of equal codes (all, the first 512 columns,
    and by quarter of the columns in GPTQ order) and both proxy losses."""
    plans, out, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        Wd, Hd = W.to(dev), H.to(dev)
        plans[dev] = claq_lib.plan_matrix(Wd, qcfg)
        t0 = time.perf_counter()
        out[dev] = claq_lib.quantize_matrix(Wd, Hd, qcfg, plans[dev])
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    assert np.array_equal(plans["cuda"].column_bits, plans["cpu"].column_bits)
    assert np.array_equal(plans["cuda"].reserve_counts,
                          plans["cpu"].reserve_counts)
    eq = (codes_of(out["cuda"][0]).cpu() == codes_of(out["cpu"][0])).float()
    q = eq.shape[1] // 4
    lg, lc = out["cuda"][2].proxy_loss, out["cpu"][2].proxy_loss
    return dict(codes_equal=float(eq.mean()),
                codes_equal_first_512=float(eq[:, :512].mean()),
                codes_equal_by_quarter=[float(eq[:, i * q:(i + 1) * q].mean())
                                        for i in range(4)],
                proxy_loss_card=lg, proxy_loss_cpu=lc,
                proxy_loss_rel_diff=abs(lg - lc) / abs(lc),
                card_s=secs["cuda"], cpu_s=secs["cpu"])


def phase_quantize_serve(api, dm, ServingEngine, cfg, prompts):
    """Quantize a random-init full-width llama1_7b (``QUANT_DEPTH``
    layers) on the card with the launcher's recipe for ``--bits 2.2``;
    hold one 4096x4096 matrix against the CPU; serve it with int8
    activations.  Returns the record."""
    from repro_torch.core import APConfig, CLAQConfig
    from repro_torch.core import claq as claq_lib
    from repro_torch.data import calibration_set
    from repro_torch.launch import quantize as lq

    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4))
    dcfg = dataclasses.replace(cfg, n_layers=QUANT_DEPTH)
    model = api.init_params(torch.Generator(device="cuda").manual_seed(
        SEED + 3), dcfg, "cuda")
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
    # 16384 rows); the two calibration Hessians of layer 0 (rank <= the
    # number of distinct tokens: its input is a function of the token
    # alone) are reported.
    W = model.blocks[0].attn.q.kernel.float().T.contiguous()
    rich = lq.calibrate(model, dcfg, calibration_set(dcfg.vocab, 128, 64),
                        batch_size=16)["layers.0.attn.q"]
    X = torch.randn((16384, W.shape[1]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 4))
    gauss = 2.0 * (X.T @ X) / X.shape[0]
    del X
    checks = {}
    for tag, H in (("calib_512_tokens", hessians["layers.0.attn.q"]),
                   ("calib_8192_tokens", rich),
                   ("gaussian_16384_rows", gauss)):
        checks[tag] = card_vs_cpu(claq_lib, W, H, qcfg)
        log(f"quantize card-vs-cpu 4096x4096 {tag} "
            + json.dumps(checks[tag]))
    full = checks["gaussian_16384_rows"]
    assert full["codes_equal_first_512"] >= 0.99, full
    assert full["proxy_loss_rel_diff"] <= 1e-3, full
    del rich, gauss

    # the launcher's pipeline on the card, timed per matrix
    seconds = {}
    inner = claq_lib.quantize_matrix

    def timed(W, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner(W, *a, **k)
        torch.cuda.synchronize()
        seconds.setdefault("x".join(map(str, W.shape)), []).append(
            time.perf_counter() - t)
        return r

    claq_lib.quantize_matrix = timed
    try:
        t0 = time.perf_counter()
        model, report = lq.quantize_model_params(model, dcfg, hessians, qcfg)
        quant_s = time.perf_counter() - t0
    finally:
        claq_lib.quantize_matrix = inner
    del hessians
    torch.cuda.empty_cache()
    assert len(report.stats) == 7 * QUANT_DEPTH
    assert 2.15 < report.mean_effective_bits < 2.25, report.mean_effective_bits
    eng = ServingEngine(model, dcfg, n_slots=4, max_len=256,
                        dtype=torch.bfloat16, act_dtype="int8",
                        device="cuda")
    res = drive(eng, prompts, dm, api, dcfg, "quantize_serve")
    res.update(depth=QUANT_DEPTH, calibrate_s=calib_s, quantize_s=quant_s,
               quantize_s_per_layer=quant_s / QUANT_DEPTH,
               seconds_per_matrix={k: float(np.mean(v))
                                   for k, v in seconds.items()},
               mean_effective_bits=report.mean_effective_bits,
               total_proxy_loss=report.total_proxy_loss,
               card_vs_cpu=checks)
    log("quantize " + json.dumps({k: res[k] for k in (
        "depth", "calibrate_s", "quantize_s", "quantize_s_per_layer",
        "seconds_per_matrix", "mean_effective_bits", "total_proxy_loss")}))
    return res


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
    from repro_torch.serve import ServingEngine

    # 1. device
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

    # 3. small-input reference (card vs CPU)
    small = dataclasses.replace(get_smoke_config("llama1_7b"), vocab=128)
    phase_small_reference(api, ServingEngine, small, gen, host_gen)

    # 4. full-width serving
    cfg = get_config("llama1_7b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.dtype) == (
        32, 4096, 11008, "bfloat16")
    serve, model, prompts = phase_serve(api, dm, ServingEngine,
                                        module_tensors, cfg, gen, host_gen)

    # 5. kernel vs plain version at the shapes the serve phase ran, on the
    # served model's first plan of each matrix shape
    served = {}
    for m in quantized_modules(model):
        served.setdefault(tuple(m.kernel.shape), m.kernel)
    assert sorted(served) == sorted(LLAMA_SHAPES), sorted(served)
    cases, max_err = phase_kernels(dm, ops, plan, ref, served,
                                   serve["kernel_m"], gen, host_gen)

    # 6. the same model and prompts with int8 activations (K1e)
    serve8 = phase_serve_int8(api, dm, ServingEngine, cfg, model, prompts)
    del model

    # 7. K1e vs plain version at every M phase 6 gave it
    cases8, max_err8 = phase_kernels(dm, ops, plan, ref, served,
                                     serve8["kernel_m"], gen, host_gen,
                                     act="int8")
    del served
    torch.cuda.empty_cache()

    # 8. quantize on the card, then serve with int8 activations
    qserve = phase_quantize_serve(api, dm, ServingEngine, cfg, prompts)

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
               serve, main_case(cases, serve["decode_m"]), max_err, cases,
               "main_path_launches"),
        record("dequant_matmul_int8",
               "src/repro/kernels/dequant_matmul.py:160", serve8,
               main_case(cases8, serve8["decode_m"]), max_err8, cases8,
               "main_path_int8_launches"),
    ]
    kernels[1]["launches_quantize_serve"] = qserve["main_path_int8_launches"]
    assert kernels[0]["launches"] > 0, "the main path never launched K1"
    assert kernels[1]["launches"] > 0, "the int8 path never launched K1e"
    assert kernels[1]["launches_quantize_serve"] > 0
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
