"""The CLAQ PTQ pipeline: calibrate -> plan -> quantize -> package (port
of ``repro.launch.quantize``; every family).

Calibration runs the model forward under ``modules.collecting``: every
dense matmul streams its input into an (in, in) Hessian keyed by the
reference's tap name (``layers.{i}.attn.q``).  Quantization then replaces,
IN PLACE, each block ``Dense.kernel`` with its CLAQ ``QuantizedTensor``
(embedding, norms, the MoE router and ``lm_head`` stay fp, the paper's
weight-only scope; each MoE expert is quantized with its own Hessian
from the ``expert_in_{e}`` / ``expert_mid_{e}`` taps and the experts are
stacked again on their E axis):
at full width a second copy of the model would not fit beside the first.
encdec quantizes its ``enc.{i}`` / ``dec.{i}`` blocks, the hybrid its
Mamba2 layers and the shared block, each matrix of which is looked up as
the reference looks it up, by its parameter path: the shared q/k/v/o take
the sum of their per-site Hessians, while the Mamba2 matrices (taps
``layers.{i}.mamba.*``, path ``layers.{i}.in_proj``) and the shared MLP
(taps ``shared_attn.site{s}.gate``, path ``mlp.gate``) find none and are
quantized in weight space, exactly as the reference quantizes them.
Everything runs on the model's device.  ``claq_quantize_with_draft``
calibrates once and quantizes the same fp weights twice, into the serving
target and a low-bit speculative draft.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import claq as claq_lib
from repro_torch.core.policy import CLAQConfig, draft_config
from repro_torch.core.quantized import stack_quantized
from repro_torch.models import api
from repro_torch.models import modules as M
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf

# parameter names never quantized (as in the reference)
_SKIP_KEYS = ("embedding", "scale", "bias", "a_log", "dt_bias", "d_skip",
              "conv_w", "conv_b", "mix", "w_bias", "u_bonus", "router",
              "lora_a", "lora_b")


@torch.no_grad()
def calibrate(model, cfg, calib_tokens: torch.Tensor,
              batch_size: int = 4) -> Dict[str, torch.Tensor]:
    """Run calibration batches through the model; returns
    {tap_name: (in, in) Hessian} on the model's device.  encdec batches
    get zero frames of the tokens' shape, as in the reference."""
    tf.validate_family(cfg)
    dev = model.embedding.device
    collector = M.TapCollector()
    with M.collecting(collector, model):
        for i in range(0, calib_tokens.shape[0], batch_size):
            chunk = calib_tokens[i:i + batch_size].to(dev)
            if cfg.family == "encdec":
                frames = torch.zeros(chunk.shape + (cfg.d_model,), device=dev)
                api.loss_fn(model, cfg, {"tokens": chunk, "frames": frames})
            else:
                tf.forward(model, cfg, chunk)
    return collector.finalized()


@dataclasses.dataclass
class QuantizeReport:
    stats: Dict[str, claq_lib.QuantStats]

    @property
    def mean_effective_bits(self) -> float:
        if not self.stats:
            return 0.0
        return float(np.mean([s.effective_bits for s in self.stats.values()]))

    @property
    def total_proxy_loss(self) -> float:
        return float(np.sum([s.proxy_loss for s in self.stats.values()]))


def block_matrices(block: torch.nn.Module):
    """(dotted name, Dense) of every quantizable matrix of one block: a
    dense 2-D kernel, no skipped name, both sides at least 16."""
    for name, m in block.named_modules():
        if (isinstance(m, M.Dense) and isinstance(m.kernel, torch.Tensor)
                and m.kernel.dim() == 2 and min(m.kernel.shape) >= 16
                and not any(k in name for k in _SKIP_KEYS)):
            yield name, m


def _param_path(cfg, name: str) -> str:
    """A block matrix's path in the reference's parameter tree: the
    hybrid keeps its Mamba2 leaves flat in the block (no ``mamba.``)."""
    if cfg.family == "hybrid":
        return name.removeprefix("mamba.")
    return name


def _quantize_blocks(blocks, prefix: str, cfg, hessians, qcfg, stats):
    for i, block in enumerate(blocks):
        for name, m in list(block_matrices(block)):
            tap = f"{prefix}.{i}.{_param_path(cfg, name)}"
            qt, _, st = claq_lib.quantize_matrix(m.kernel.float().T,
                                                 hessians.get(tap), qcfg)
            stats[tap] = st
            m.set_kernel(qt)
        if isinstance(getattr(block, "mlp", None), moe_lib.MoE):
            _quantize_experts(block.mlp, f"{prefix}.{i}.mlp", hessians, qcfg,
                              stats)


@torch.no_grad()
def quantize_model_params(model, cfg, hessians: Dict[str, torch.Tensor],
                          qcfg: CLAQConfig) -> Tuple[torch.nn.Module,
                                                     QuantizeReport]:
    """Quantize every block matrix of ``model`` in place (kernel (in, out)
    -> QuantizedTensor in paper layout (out, in)); stats are keyed
    ``layers.{i}.attn.q`` (``enc.{i}`` / ``dec.{i}``,
    ``shared_attn.q``) as in the reference.  Returns (model, report)."""
    tf.validate_family(cfg)
    stats: Dict[str, claq_lib.QuantStats] = {}
    if cfg.family == "encdec":
        _quantize_blocks(model.enc_blocks, "enc", cfg, hessians, qcfg, stats)
        _quantize_blocks(model.dec_blocks, "dec", cfg, hessians, qcfg, stats)
        return model, QuantizeReport(stats)
    _quantize_blocks(model.blocks, "layers", cfg, hessians, qcfg, stats)
    if model.shared_attn is not None:
        # shared across sites: the sum of the per-site Hessians whose tap
        # is the site prefix + the parameter path
        for name, m in list(block_matrices(model.shared_attn)):
            rx = re.compile(r"shared_attn\.site\d+\." + re.escape(name))
            H = None
            for tap, Hs in hessians.items():
                if rx.fullmatch(tap):
                    H = Hs if H is None else H + Hs
            qt, _, st = claq_lib.quantize_matrix(m.kernel.float().T, H, qcfg)
            stats[f"shared_attn.{name}"] = st
            m.set_kernel(qt)
    return model, QuantizeReport(stats)


def _quantize_experts(mlp, prefix: str, hessians, qcfg: CLAQConfig,
                      stats) -> None:
    """Quantize each expert of ``mlp``'s (E, in, out) stacks with its own
    Hessian (``expert_in_{e}`` for gate/up, ``expert_mid_{e}`` for down)
    and stack the results on E, in place; the stack's stat is its last
    expert's, keyed as the reference keys it (``{prefix}.w_gate.w_gate``)."""
    for name in ("w_gate", "w_up", "w_down"):
        dm = getattr(mlp, name)
        k = dm.kernel
        if not (isinstance(k, torch.Tensor) and min(k.shape[1:]) >= 16):
            continue
        tap = "expert_mid" if name == "w_down" else "expert_in"
        qts = []
        for e in range(k.shape[0]):
            qt, _, st = claq_lib.quantize_matrix(
                k[e].float().T, hessians.get(f"{prefix}.{tap}_{e}"), qcfg)
            qts.append(qt)
        stats[f"{prefix}.{name}.{name}"] = st
        dm.set_kernel(stack_quantized(qts))


def claq_quantize(model, cfg, calib_tokens: torch.Tensor,
                  qcfg: CLAQConfig, batch_size: int = 4
                  ) -> Tuple[torch.nn.Module, QuantizeReport]:
    """End to end: calibrate + quantize (in place), the paper's pipeline."""
    hessians = calibrate(model, cfg, calib_tokens, batch_size)
    return quantize_model_params(model, cfg, hessians, qcfg)


def claq_quantize_with_draft(model, cfg,
                             calib_tokens: torch.Tensor, qcfg: CLAQConfig,
                             draft_qcfg: Optional[CLAQConfig] = None,
                             draft_bits: int = 2, batch_size: int = 4):
    """ONE calibration pass, TWO quantizations of the same fp weights: the
    serving target at ``qcfg`` and a low-bit speculative draft at
    ``draft_qcfg`` (default ``core.draft_config(qcfg, draft_bits)``: flat
    ``draft_bits`` codes, Outlier Reservation kept, AP dropped), both from
    the same tapped Hessians.

    The draft is a second module tree that shares every tensor of
    ``model`` (embedding, norms, lm_head, the fp kernels until they are
    replaced), so no fp copy of the weights is made; then both are
    quantized in place, the draft first.  Returns ``(target,
    target_report), (draft, draft_report)``."""
    hessians = calibrate(model, cfg, calib_tokens, batch_size)
    if draft_qcfg is None:
        draft_qcfg = draft_config(qcfg, draft_bits)
    shared = {id(t): t for t in M.module_tensors(model)}
    draft = quantize_model_params(copy.deepcopy(model, shared), cfg,
                                  hessians, draft_qcfg)
    target = quantize_model_params(model, cfg, hessians, qcfg)
    return target, draft
