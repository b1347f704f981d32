"""The CLAQ PTQ pipeline: calibrate -> plan -> quantize -> package (port
of ``repro.launch.quantize``, dense family).

Calibration runs the model forward under ``modules.collecting``: every
dense matmul streams its input into an (in, in) Hessian keyed by the
reference's tap name (``layers.{i}.attn.q``).  Quantization then replaces,
IN PLACE, each block ``Dense.kernel`` with its CLAQ ``QuantizedTensor``
(embedding, norms and ``lm_head`` stay fp, the paper's weight-only scope):
at full width a second copy of the model would not fit beside the first.
Everything runs on the model's device.  ``claq_quantize_with_draft`` waits
for the port's speculative-decoding slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import claq as claq_lib
from repro_torch.core.policy import CLAQConfig
from repro_torch.models import modules as M
from repro_torch.models import transformer as tf

# parameter names never quantized (as in the reference)
_SKIP_KEYS = ("embedding", "scale", "bias", "a_log", "dt_bias", "d_skip",
              "conv_w", "conv_b", "mix", "w_bias", "u_bonus", "router",
              "lora_a", "lora_b")


@torch.no_grad()
def calibrate(model: tf.Transformer, cfg, calib_tokens: torch.Tensor,
              batch_size: int = 4) -> Dict[str, torch.Tensor]:
    """Run calibration batches through the model; returns
    {tap_name: (in, in) Hessian} on the model's device."""
    tf.validate_family(cfg)
    dev = model.embedding.device
    collector = M.TapCollector()
    with M.collecting(collector, model):
        for i in range(0, calib_tokens.shape[0], batch_size):
            tf.forward(model, cfg, calib_tokens[i:i + batch_size].to(dev))
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


@torch.no_grad()
def quantize_model_params(model: tf.Transformer, cfg,
                          hessians: Dict[str, torch.Tensor],
                          qcfg: CLAQConfig
                          ) -> Tuple[tf.Transformer, QuantizeReport]:
    """Quantize every block matrix of ``model`` in place (kernel (in, out)
    -> QuantizedTensor in paper layout (out, in)); stats are keyed
    ``layers.{i}.attn.q`` as in the reference.  Returns (model, report)."""
    tf.validate_family(cfg)
    stats: Dict[str, claq_lib.QuantStats] = {}
    for i, block in enumerate(model.blocks):
        for name, m in list(block_matrices(block)):
            tap = f"layers.{i}.{name}"
            qt, _, st = claq_lib.quantize_matrix(m.kernel.float().T,
                                                 hessians.get(tap), qcfg)
            stats[tap] = st
            m.set_kernel(qt)
    return model, QuantizeReport(stats)


def claq_quantize(model: tf.Transformer, cfg, calib_tokens: torch.Tensor,
                  qcfg: CLAQConfig, batch_size: int = 4
                  ) -> Tuple[tf.Transformer, QuantizeReport]:
    """End to end: calibrate + quantize (in place), the paper's pipeline."""
    hessians = calibrate(model, cfg, calib_tokens, batch_size)
    return quantize_model_params(model, cfg, hessians, qcfg)
