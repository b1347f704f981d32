"""Dry run (port of ``repro.launch.dryrun``): trace every (arch x shape x
mesh) cell on rank 0 of the production mesh and extract the FLOP, byte
and collective figures of its roofline, without a card or a process
group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama1_7b \
      --shape train_4k --mesh single --out /tmp/dry.json

The reference lowers and compiles each cell on 512 forced host devices
and reads the compiled HLO.  The port builds the model on the ``meta``
device (no memory), takes rank 0's blocks by the sharding rules on a
stand-in of the mesh (``dist.standin.StandInMesh``: (16, 16) single, (2,
16, 16) multi) and runs the cell's entry point once -- train (loss,
backward and the AdamW update), prefill or decode -- under the op
recorder (``analysis.op_trace.record``) and torch's ``FlopCounterMode``.
The stand-in's collectives return meta tensors and record their kind and
bytes, so the trace holds what a real rank of that mesh would run;
``dist.op_analysis.analyze_ops`` reads it with the reference's
conventions.  Results are cached per cell in the JSON; finished cells
are skipped unless ``--force``.

The JSON keeps the reference's keys.  ``per_device.hlo_flops`` /
``hlo_bytes`` are the op stream's (there is no HLO in eager torch),
``xla_cost_flops_1iter`` is torch's own ``FlopCounterMode`` count (it
cannot see K1 on meta tensors, which the op stream charges), and
``temp_bytes`` is None (meta tensors have no allocator).  A moe cell
takes ``moe_groups`` = the data shards (halved until the tokens divide),
as the reference's does, so a data rank routes whole groups of its own
rows.  Every family of the configs traces on both production meshes;
``long_500k`` is skipped for the full-attention archs, as in the
reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.analysis import op_trace
from repro_torch.configs import (ARCH_IDS, SHAPES, SHAPES_BY_NAME,
                                 cell_applicable, get_config)
from repro_torch.dist import context as dctx
from repro_torch.dist import op_analysis
from repro_torch.dist import sharding as shd
from repro_torch.dist.standin import StandInMesh
from repro_torch.models import api
from repro_torch.models.modules import module_tensors
from repro_torch.optim import OptimConfig, init_opt_state
from repro_torch.train import make_train_step
from repro_torch.train.step import local_batch

# --- NVIDIA H100 SXM5 data sheet figures (per card) ------------------------
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 900e9          # NVLink 4 bytes/s a GPU, within a node
NIC_BW = 400e9 / 8         # one 400 Gb/s NIC a GPU: an axis wider than a node
NODE_GPUS = 8

PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


def collective_stats(trace: op_trace.OpTrace) -> dict:
    """Per-device collective bytes (result-shape proxy) by op kind, and
    their ``total``."""
    out = {}
    for kind, b in op_trace.collective_instructions(trace):
        out[kind] = out.get(kind, 0) + b
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Model FLOPs (analytic "useful work" reference)
# ---------------------------------------------------------------------------

def count_params(cfg) -> dict:
    """Parameter counts from the meta model in the reference's layout
    (``convert.param_tree``: names and stacked shapes as the reference's
    tree)."""
    model = api.init_params(torch.Generator(), cfg, "meta")
    total = active = embed = 0
    for name, leaf in tree_lib.flatten(convert.param_tree(model, cfg)):
        n = math.prod(shd.leaf_shape(leaf))
        total += n
        if "embed" in name or "lm_head" in name:
            embed += n
            continue
        if any(k in name for k in ("w_gate", "w_up", "w_down")):
            active += n * cfg.top_k // max(cfg.n_experts, 1)
        else:
            active += n
    return {"total": total, "active_nonembed": active, "embed": embed,
            "nonembed": total - embed}


def _attention_flops(cfg, B, S, kind) -> float:
    """Analytic 'useful' mixing flops (causal-optimal; the MODEL_FLOPS
    reference the roofline fraction is measured against)."""
    H, hd, L_ = cfg.n_heads, cfg.head_dim, cfg.n_layers
    if cfg.family == "encdec":
        Le, Ld = cfg.enc_layers, cfg.dec_layers
        enc = 4.0 * B * S * S * H * hd * Le           # bidirectional
        dec_self = 2.0 * B * S * S * H * hd * Ld      # causal
        cross = 4.0 * B * S * S * H * hd * Ld
        fwd = enc + dec_self + cross
    elif cfg.use_mla:
        dqk = cfg.head_dim + cfg.rope_head_dim
        fwd = (B * S * S * H * (dqk + cfg.v_head_dim)) * L_
    elif cfg.family == "rwkv":
        Hh = cfg.d_model // cfg.rwkv_head_dim
        N = cfg.rwkv_head_dim
        c = cfg.rwkv_chunk
        # intra-chunk quadratic + state in/out terms
        fwd = (4.0 * B * S * c * Hh * N + 4.0 * B * S * Hh * N * N) * L_
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        Hh = d_inner // cfg.ssm_headdim
        c = cfg.ssm_chunk
        ssd = (2.0 * B * S * c * (cfg.ssm_state + cfg.ssm_headdim) * Hh
               + 4.0 * B * S * Hh * cfg.ssm_headdim * cfg.ssm_state) * L_
        W = min(cfg.attn_window or S, S)
        attn = 2.0 * B * S * W * H * hd * cfg.n_sites
        fwd = ssd + attn
    else:
        W = min(cfg.attn_window or S, S)
        fwd = 2.0 * B * S * W * H * hd * L_           # causal (S*W/2 pairs x2)

    if kind == "train":
        return 3.0 * fwd
    return fwd


def _decode_attention_flops(cfg, B, S_ctx) -> float:
    H, hd, L_ = cfg.n_heads, cfg.head_dim, cfg.n_layers
    if cfg.family == "encdec":
        Ld = cfg.dec_layers
        return 4.0 * B * S_ctx * H * hd * Ld * 2      # self cache + cross
    if cfg.use_mla:
        # absorbed decode: scores/context against the latent cache
        return 4.0 * B * S_ctx * cfg.n_heads * cfg.kv_lora * L_
    if cfg.family == "rwkv":
        Hh = cfg.d_model // cfg.rwkv_head_dim
        return 6.0 * B * Hh * cfg.rwkv_head_dim ** 2 * L_
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        Hh = d_inner // cfg.ssm_headdim
        ssm = 6.0 * B * Hh * cfg.ssm_headdim * cfg.ssm_state * L_
        W = min(cfg.attn_window or S_ctx, S_ctx)
        return ssm + 4.0 * B * W * H * hd * cfg.n_sites
    W = min(cfg.attn_window or S_ctx, S_ctx)
    return 4.0 * B * W * H * hd * L_


def model_flops(cfg, cell, counts) -> float:
    """Useful work: parameter matmuls (6ND train / 2ND inference, active
    params for MoE) + analytic attention/SSD/WKV mixing flops."""
    B, S = cell.global_batch, cell.seq_len
    tokens = B * S
    n = counts["active_nonembed"]
    if cell.kind == "train":
        return 6.0 * n * tokens + _attention_flops(cfg, B, S, "train")
    if cell.kind == "prefill":
        return 2.0 * n * tokens + _attention_flops(cfg, B, S, "prefill")
    return 2.0 * n * B + _decode_attention_flops(cfg, B, S)


# ---------------------------------------------------------------------------
# Quantized-parameter stand-ins (shape-only CLAQ tensors on meta; no GPTQ
# run is needed to trace the quantized serving path)
# ---------------------------------------------------------------------------

def _qt_struct(n_layers, rows, cols, qcfg, stack=()):
    """A ``LayerStack`` of ``n_layers`` QuantizedTensors on meta (data
    leaves with leading ``stack`` axes: an expert stack), of the
    reference's stand-in shapes (``repro.launch.dryrun._qt_struct``)."""
    from repro_torch.core import packing
    from repro_torch.core.policy import BITS_PER_RESERVED_OUTLIER
    from repro_torch.core.quantized import QuantizedTensor, QuantStripe

    def meta(shape, dtype):
        return torch.empty(tuple(stack) + shape, dtype=dtype, device="meta")

    if qcfg.ap is not None:
        frac = ((qcfg.ap.target_bits - qcfg.ap.p_lo)
                / (qcfg.ap.p_hi - qcfg.ap.p_lo))
        n_hi = int(round(frac * cols))
        parts = [(qcfg.ap.p_lo, cols - n_hi), (qcfg.ap.p_hi, n_hi)]
    else:
        parts = [(qcfg.bits, cols)]
    k_max = 0
    if qcfg.orr is not None:
        total = (qcfg.orr.extra_bits * rows * cols
                 / BITS_PER_RESERVED_OUTLIER)
        n_top = max(int(round(qcfg.orr.top_frac * cols)), 1)
        k1 = min(int(round(qcfg.orr.o1 * total / n_top)), rows)
        k2 = min(int(round(qcfg.orr.o2 * total / max(cols - n_top, 1))),
                 rows)
        k_max = max(k1, k2)

    def one():
        return QuantizedTensor(
            stripes=tuple(
                QuantStripe(packed=meta((packing.packed_rows(rows, b), n),
                                        torch.int32),
                            codebook=meta((n, 2 ** b), torch.float32),
                            bits=b)
                for b, n in parts if n > 0),
            col_perm=meta((cols,), torch.int32),
            out_idx=meta((k_max, cols), torch.int32),
            out_val=meta((k_max, cols), torch.float32),
            out_count=meta((cols,), torch.int32),
            shape=(rows, cols))

    return tree_lib.LayerStack(one() for _ in range(n_layers))


def quantize_param_sds(params, cfg, qcfg):
    """Replace eligible block kernels of a param tree (the reference's
    layout, ``convert.param_tree``) with QuantizedTensor stand-ins (paper
    layout rows=out, cols=in), mirroring the quantizer's rules."""
    from repro_torch.launch.quantize import _SKIP_KEYS

    def walk(name, leaf):
        if not isinstance(leaf, tree_lib.LayerStack) or \
                not isinstance(leaf[0], torch.Tensor):
            return leaf
        shape = shd.leaf_shape(leaf)
        last = name.rsplit("[", 1)[-1].strip("]'\"")
        low = name.lower()
        if (last == "kernel" and len(shape) == 3
                and not any(k in low for k in _SKIP_KEYS)
                and min(shape[1:]) >= 16):
            L_, d_in, d_out = shape
            return _qt_struct(L_, d_out, d_in, qcfg)
        if (last in ("w_gate", "w_up", "w_down") and len(shape) == 4
                and min(shape[2:]) >= 16):
            L_, E, d_in, d_out = shape
            return _qt_struct(L_, d_out, d_in, qcfg, stack=(E,))
        return leaf

    new = dict(params)
    for key in ("blocks", "enc_blocks", "dec_blocks"):
        if key in new:
            new[key] = tree_lib.map_with_name(walk, new[key],
                                              prefix=f"[{key!r}]")
    return new


def quant_config(quant: str):
    """The CLAQ config of a ``quant=`` bit-width ('2.12': AP 2/4 bits +
    OR, the paper's fusion), as the reference's ``lower_cell`` builds
    it."""
    from repro_torch.core import APConfig, CLAQConfig, ORConfig
    bits = float(quant)
    base = int(bits)
    return CLAQConfig(
        bits=base,
        ap=(APConfig(base + (bits - base) * 0.6, base, 4)
            if bits != base else None),
        orr=(ORConfig((bits - base) * 0.4) if bits != base else None))


def _plan_struct(qt, bn: int):
    """The deployment plan (N block ``bn``) of a stand-in QuantizedTensor,
    on meta: the stand-in's column order is unknown, so every group takes
    the general (gathered) route with its x_idx tables."""
    from repro_torch.kernels import plan
    layout = plan._static_group_layout(qt.stripes, plan.DEFAULT_BK)
    return plan._build_plan(qt, bn=bn, layout=layout,
                            x_starts=[None] * len(layout))


def install_standins(model, cfg, qcfg, plan_bn: int) -> None:
    """Set every block matrix the quantizer would quantize (its
    ``block_matrices``: the hybrid's shared block's too, which
    ``launch.quantize`` quantizes once for every site) and every expert
    stack to a stand-in plan (a stack's: stacked on E, as
    ``launch.quantize`` stacks the experts).  The reference's
    ``quantize_param_sds`` walks the layer stacks only, so its hybrid
    cells trace the shared block in fp.  For encdec it quantizes the same
    matrices as this: every kernel of ``enc_blocks`` (attention q/k/v/o,
    the GELU MLP's up/down) and of ``dec_blocks`` (those and the cross
    attention's q/k/v/o); the embedding and ``lm_head`` stay fp in both."""
    from repro_torch.launch.quantize import block_matrices
    from repro_torch.models.moe import MoE
    blocks = [b for key in ("blocks", "enc_blocks", "dec_blocks")
              for b in getattr(model, key, None) or ()]
    if getattr(model, "shared_attn", None) is not None:
        blocks.append(model.shared_attn)
    for block in blocks:
        mats = list(block_matrices(block))
        if isinstance(getattr(block, "mlp", None), MoE):
            mats += [(n, getattr(block.mlp, n))
                     for n in ("w_gate", "w_up", "w_down")]
        for _, m in mats:
            *stack, d_in, d_out = m.kernel.shape
            m.set_kernel(_plan_struct(_qt_struct(
                1, d_out, d_in, qcfg, stack=tuple(stack))[0], plan_bn))


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def prepare_cell(arch: str, shape_name: str, multi_pod: bool):
    cfg = get_config(arch)
    mesh = StandInMesh(PRODUCTION[multi_pod])
    ax = shd.MeshAxes(mesh)
    cell = SHAPES_BY_NAME[shape_name]
    if cfg.family == "moe":
        groups = ax.dp_size
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                      else 1)
        while groups > 1 and tokens % groups != 0:
            groups //= 2
        cfg = dataclasses.replace(cfg, moe_groups=groups)
    return cfg, mesh, cell


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in op_trace._tensors(tree))


def trace_cell(cfg, cell, mesh, quant: Optional[str] = None, *,
               plan_bn: int = None) -> dict:
    """Build ``cfg`` on meta, place rank ``mesh``'s blocks and run the
    cell's entry point once under the op recorder and ``FlopCounterMode``:
    {"trace", "flop_counter", "argument_bytes", "output_bytes"}.  A
    train cell runs ``make_train_step`` (the global batch; the step takes
    its data rank's rows), prefill / decode the model's step on this
    data rank's rows and cache slots.  ``quant``
    stand-in plans take the N block ``plan_bn`` (default: the plans'
    ``DEFAULT_BN``)."""
    from repro_torch.kernels.plan import DEFAULT_BN
    model = api.init_params(torch.Generator(), cfg, "meta")
    if quant:
        if cell.kind == "train":
            raise ValueError("a quantized model has no gradient: quant= "
                             "applies to prefill and decode cells")
        install_standins(model, cfg, quant_config(quant),
                         plan_bn or DEFAULT_BN)
    shd.place_model(model, cfg, mesh)
    batch = api.input_specs(cfg, cell)
    with dctx.use_mesh(mesh):
        if cell.kind == "train":
            ocfg = OptimConfig(total_steps=10000)
            opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
            step = make_train_step(cfg, ocfg)
            args = (list(module_tensors(model)), opt, batch)

            def fn():
                return step(model, opt, batch)[1:]
        else:
            cache = shd.place_cache(api.cache_specs(cfg, cell), cfg, mesh)
            local = local_batch(batch, cfg, mesh)
            args = (list(module_tensors(model)), local, cache)
            if cell.kind == "prefill":
                def fn():
                    with dctx.rows_over_dp():
                        return api.prefill_step(model, cfg, local, cache)
            else:
                def fn():
                    with dctx.rows_over_dp():
                        return api.decode_step(model, cfg, local["token"],
                                               cache)
        with FlopCounterMode(display=False) as fc:
            out, trace = op_trace.record(fn)
    inputs = {id(t) for t in op_trace._tensors(args)}
    return {"trace": trace, "flop_counter": float(fc.get_total_flops()),
            "argument_bytes": _nbytes(args),
            "output_bytes": sum(t.numel() * t.element_size()
                                for t in op_trace._tensors(out)
                                if id(t) not in inputs)}


def figures(traced: dict) -> dict:
    """The numbers of one traced cell: ``op_analysis.analyze_ops``'s keys,
    ``collective_s`` and the trace's byte and FLOP counts."""
    return {**op_analysis.analyze_ops(traced["trace"]),
            "collective_s": collective_seconds(traced["trace"]),
            **{k: traced[k] for k in ("flop_counter", "argument_bytes",
                                      "output_bytes")}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               quant: Optional[str] = None):
    """Returns (the cell's figures, (cfg, mesh, cell)).  quant: e.g. '2.12'
    traces the serving path with CLAQ stand-in plans (AP+OR at that
    bit-width), the paper's deployment format in the dry run.

    A model's layers are identical, so the cell is traced at 1 and 2
    layers and every figure is extrapolated to ``n_layers`` as
    ``f(1) + (n_layers - 1) * (f(2) - f(1))``, as the reference's analyzer
    charges its scanned layer body once per trip (tracing all 32 layers
    of a train_4k step op by op takes minutes on the host).  The hybrid's
    are not: a shared-attention site runs before every ``attn_every``-th
    Mamba2 layer, and the 1- and 2-layer traces hold one site each.  A
    third trace, of 2 layers with a site before each, gives a site's
    figures, so Mamba2 layers and sites are counted apart:
    ``+ (n_sites - 1) * (f(2 layers, 2 sites) - f(2 layers, 1 site))``.
    encdec reads ``enc_layers`` and ``dec_layers``, not ``n_layers``: it is
    traced at (enc, dec) = (1, 1), (2, 1) and (1, 2), and an encoder layer
    and a decoder layer are counted apart:
    ``f(1,1) + (Le - 1)(f(2,1) - f(1,1)) + (Ld - 1)(f(1,2) - f(1,1))``."""
    cfg, mesh, cell = prepare_cell(arch, shape_name, multi_pod)
    return cell_figures(cfg, cell, mesh, quant), (cfg, mesh, cell)


def cell_figures(cfg, cell, mesh, quant: Optional[str] = None, *,
                 plan_bn: int = None) -> dict:
    """The figures of ``cfg``'s cell on ``mesh``, extrapolated from 1- and
    2-layer traces (and, for the hybrid, a 2-site one; for encdec, an
    encoder and a decoder layer apart) as ``lower_cell`` says."""
    def traced(**kw):
        return figures(trace_cell(dataclasses.replace(cfg, **kw), cell, mesh,
                                  quant, plan_bn=plan_bn))

    if cfg.family == "encdec":
        def layers(enc, dec):
            return traced(enc_layers=enc, dec_layers=dec, n_layers=enc + dec)

        f11 = layers(1, 1)
        out = extrapolate(f11, layers(2, 1), cfg.enc_layers)
        return extrapolate(out, _plus(out, f11, layers(1, 2)),
                           cfg.dec_layers)
    if cfg.n_layers <= 2:
        return traced()
    f1, f2 = traced(n_layers=1), traced(n_layers=2)
    out = extrapolate(f1, f2, cfg.n_layers)
    if cfg.family == "hybrid" and cfg.attn_every > 1:
        site = _plus(out, f2, traced(n_layers=2, attn_every=1))
        out = extrapolate(out, site, cfg.n_sites)
    return out


def _plus(base: dict, lo: dict, hi: dict) -> dict:
    """``base + (hi - lo)`` key by key (a missing key counts 0)."""
    keys = sorted(set(base) | set(lo) | set(hi))
    return {k: base.get(k, 0.0) + hi.get(k, 0.0) - lo.get(k, 0.0)
            for k in keys}


def extrapolate(f1: dict, f2: dict, n_layers: int) -> dict:
    """``f1 + (n_layers - 1) * (f2 - f1)`` key by key (a key missing from
    one side counts 0 there)."""
    return {k: f1.get(k, 0.0) + (n_layers - 1) * (f2.get(k, 0.0)
                                                   - f1.get(k, 0.0))
            for k in sorted(set(f1) | set(f2))}


def collective_seconds(trace: op_trace.OpTrace) -> float:
    """Every recorded collective's bytes over the link its group spans:
    NVLink within a node of ``NODE_GPUS``, a NIC for a wider group."""
    return sum(b / (NVLINK_BW if group <= NODE_GPUS else NIC_BW)
               for _, group, b in op_analysis.collective_groups(trace))


def analyze(f: dict, cfg, mesh, cell) -> dict:
    """Roofline terms of one cell's figures on the H100's data-sheet
    figures (a model of the mesh, not a measurement)."""
    counts = count_params(cfg)
    n_chips = mesh.size()
    flops_dev = float(f["flops"])
    bytes_dev = float(f["hbm_bytes"])
    mflops = model_flops(cfg, cell, counts)
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": float(f["collective_s"])}
    bottleneck = max(terms, key=terms.get)
    return {
        "chips": n_chips,
        "per_device": {
            "hlo_flops": flops_dev,
            "hlo_bytes": bytes_dev,
            "elementwise_flops": float(f["elementwise_flops"]),
            "collective_bytes": float(f["collective_bytes"]),
            "collectives": {k.replace("coll_", ""): v
                            for k, v in f.items() if k.startswith("coll_")},
            "xla_cost_flops_1iter": f["flop_counter"],
            "argument_bytes": f["argument_bytes"],
            "output_bytes": f["output_bytes"],
            "temp_bytes": None,
        },
        "roofline": {
            **terms,
            "bottleneck": bottleneck.replace("_s", ""),
            "model_flops_global": mflops,
            "model_flops_per_dev": mflops / n_chips,
            "useful_flop_fraction": (mflops / n_chips) / max(flops_dev, 1.0),
            "roofline_fraction": (mflops / n_chips / PEAK_FLOPS)
                                  / max(terms[bottleneck], 1e-30),
            "hardware": "NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, "
                        "3.35 TB/s HBM3, NVLink 900 GB/s within 8, "
                        "400 Gb/s NIC beyond",
        },
        "params": counts,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant: Optional[str] = None) -> dict:
    cfg0 = get_config(arch)
    cell = SHAPES_BY_NAME[shape_name]
    ok, reason = cell_applicable(cfg0, cell)
    if not ok:
        return {"status": "skipped", "reason": reason}
    t0 = time.time()
    try:
        f, (cfg, mesh, cell) = lower_cell(arch, shape_name, multi_pod,
                                          quant=quant)
        result = analyze(f, cfg, mesh, cell)
        result.update(status="ok", compile_s=round(time.time() - t0, 1))
        return result
    except Exception as e:  # a sharding bug is a bug in our system
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
                "compile_s": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if key in results and results[key].get("status") in (
                        "ok", "skipped") and not args.force:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                res = run_cell(arch, shape, mp)
                results[key] = res
                status = res["status"]
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" trace={res['compile_s']}s")
                elif status == "error":
                    extra = " " + res["error"][:160]
                print(f"[dryrun] {key} -> {status}{extra}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    count = {s: sum(1 for v in results.values() if v.get("status") == s)
             for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {count['ok']} ok, {count['skipped']} skipped, "
          f"{count['error']} errors")
    return 0 if count["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
