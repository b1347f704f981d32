#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA
H100 and hold its CUDA kernel against its plain version.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: K1 (``csrc/dequant_matmul.cu``) from the checkout's sources;
  3. reference check on a small input: the same synthetic CLAQ model
     served on the card (kernel) and on the CPU (plain version);
  4. serve llama1_7b at full width (32 layers, d 4096, bf16) with
     synthetic CLAQ AP+OR weights through ``ServingEngine``: 8 requests,
     4 slots, 16 new tokens each, with the kernel's launch counts;
  5. kernel vs plain version on the card at every (M, N, K) the serve
     phase gave K1: M = n_slots for decode and Bb * bucket for each
     prefill shape it ran, at the three matrix shapes of llama1_7b, on
     the served model's own plans (a 2/3/4-bit gathered chain through
     ``acc``, with outliers; also pre-gathered as "blocked") and on a
     single-width plan ("aligned"), f32 and bf16; times beside the bound
     and a ``torch.matmul`` yardstick on the pre-dequantized weight.
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

def phase_kernels(dm, ops, plan, served, main_ms, gen, host_gen):
    """Kernel vs plain version at every M of ``main_ms`` and each of
    llama1_7b's matrix shapes; ``served`` maps (out, in) to a plan of the
    served model.  Returns the records."""
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
                    calls = list(ops.group_calls(x, pqt, gather))
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
                                               float(diff.max()))
                        err = max(err, float(diff.max()))
                        acc = yk

                    def run(fn, calls=calls, dtype=dtype):
                        y = None
                        for xg, kw in calls:
                            y = fn(xg, acc=y, compute_dtype=dtype, **kw)
                        return y

                    w_lib = w_deq.to(dtype)
                    ms = time_ms(lambda: run(dm.dequant_matmul), 10, flush)
                    plain_ms = time_ms(lambda: run(dm.dequant_matmul_plain),
                                       3, flush)
                    lib_ms = time_ms(lambda: torch.matmul(x, w_lib.T), 10,
                                     flush)
                    nb, fl = chain_bytes_flops(pqt, m, x.element_size())
                    bound, by = bound_of(nb, fl, dtype)
                    max_err = max(max_err, err)
                    rec = dict(shape=f"{rows}x{cols}", m=m, x_mode=mode,
                               dtype=str(dtype).replace("torch.", ""),
                               launches=len(calls), max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound, bound_by=by, bytes=nb,
                               flops=fl)
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


def phase_serve(api, dm, ServingEngine, module_tensors, cfg, gen, host_gen):
    """Full-width llama1_7b through the engine; returns its records (the
    main-path launch count, timings, and ``kernel_m``: every M it gave
    K1), and the served model."""
    log("weights: SYNTHETIC CLAQ AP+OR tensors built on the card from seed "
        f"{SEED} (the port has no quantizer yet); ~90 % 2-bit, 5 % 3-bit, "
        "5 % 4-bit columns, 0-3 reserved outliers per column")
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
    launches_per_matmul = sum(len(m.kernel.groups) for m in qmods)
    assert all(t.is_cuda for t in module_tensors(model))

    lens = [5, 17, 29, 42, 56, 70, 85, 100]
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=host_gen).tolist()
               for n in lens]
    max_new = 16
    torch.cuda.reset_peak_memory_stats()
    dm.launch_count = 0
    dm.plain_count = 0
    prefill_s, decode_s, decode_launches, prefill_calls = [], [], [], 0
    order = []
    pending = list(prompts)
    t_run = time.perf_counter()
    while pending or eng.active:
        if pending and eng.free:
            batch = [pending.pop(0)
                     for _ in range(min(len(pending), len(eng.free)))]
            calls = sum(eng.bucketing.stats.per_shape.values())
            t0 = time.perf_counter()
            order += eng.add_requests(batch, max_new_tokens=max_new)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            prefill_calls += (sum(eng.bucketing.stats.per_shape.values())
                              - calls)
        before = dm.launch_count
        t0 = time.perf_counter()
        emitted = eng.step()
        torch.cuda.synchronize()
        if emitted:
            decode_s.append(time.perf_counter() - t0)
            decode_launches.append(dm.launch_count - before)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    main_launches, main_plain = dm.launch_count, dm.plain_count
    peak = torch.cuda.max_memory_allocated()

    fin = eng.take_finished()
    assert sorted(fin) == sorted(order) and len(fin) == len(prompts)
    assert all(fin[u].state.value == "finished"
               and len(fin[u].tokens) == max_new for u in order)
    assert main_plain == 0, "the main path ran the plain version on the card"
    assert set(decode_launches) == {launches_per_matmul}, \
        (set(decode_launches), launches_per_matmul)
    assert main_launches == launches_per_matmul * (prefill_calls
                                                   + len(decode_s))
    # logits of the full-width model: finite, of the expected shape
    logits, _ = api.prefill_step(
        model, cfg, {"tokens": torch.tensor([prompts[0]], device="cuda")},
        api.make_cache(cfg, 1, 256, torch.bfloat16, "cuda"))
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()

    tokens = sum(len(fin[u].tokens) for u in order)
    stats = eng.stats()
    # decode runs every slot; a prefill of shape (Bb, bucket) runs Bb*bucket
    kernel_m = sorted({eng.n_slots} | {b * n for b, n
                                       in eng.bucketing.stats.per_shape})
    res = dict(requests=len(order), new_tokens=tokens,
               prefill_calls=prefill_calls, prefill_ms=sum(prefill_s) * 1e3,
               decode_steps=len(decode_s),
               decode_ms_per_step=float(np.mean(decode_s)) * 1e3,
               decode_ms_per_step_min=float(np.min(decode_s)) * 1e3,
               tokens_per_s=tokens / run_s, run_s=run_s,
               launches_per_decode_step=launches_per_matmul,
               launches_per_prefill_call=launches_per_matmul,
               main_path_launches=main_launches,
               max_memory_allocated_gb=peak / 1e9,
               prefill_shapes=stats["prefill_traces"],
               prefill_batch_bucket=sorted(eng.bucketing.stats.per_shape),
               decode_m=eng.n_slots, kernel_m=kernel_m)
    log("serve " + json.dumps(res))
    log("sample tokens: " + str([fin[u].tokens[:8] for u in order[:2]]))
    return res, model


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
    from repro_torch.kernels import cuda_build, ops, plan
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
    serve, model = phase_serve(api, dm, ServingEngine, module_tensors, cfg,
                               gen, host_gen)

    # 5. kernel vs plain version at the shapes the serve phase ran, on the
    # served model's first plan of each matrix shape
    served = {}
    for m in quantized_modules(model):
        served.setdefault(tuple(m.kernel.shape), m.kernel)
    assert sorted(served) == sorted(LLAMA_SHAPES), sorted(served)
    del model
    cases, max_err = phase_kernels(dm, ops, plan, served, serve["kernel_m"],
                                   gen, host_gen)

    decode_m = serve["decode_m"]
    main_case = next(c for c in cases if c["shape"] == "11008x4096"
                     and c["m"] == decode_m and c["x_mode"] == "gathered"
                     and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "dequant_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dequant_matmul.cu",
        "replaces": "src/repro/kernels/dequant_matmul.py:92",
        "launches": serve["main_path_launches"],
        "max_abs_err": max_err,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timed_case": f"11008x4096 M={decode_m} (decode) gathered bf16, "
                      "3-launch chain",
        "checked_m": serve["kernel_m"],
        "max_err": max_err,
        "launched": serve["main_path_launches"] > 0,
    }]
    assert kernels[0]["launched"], "the main path never launched K1"
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
