"""Family-agnostic model API (port of ``repro.models.api``), dense family
only: the other families raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import device as dev_lib

from . import transformer as tf


def init_params(gen: torch.Generator, cfg, device="cuda"):
    return tf.init_params(gen, cfg, dev_lib.resolve(device))


def make_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    return tf.init_cache(cfg, batch, max_len, dtype, dev_lib.resolve(device))


def prefill_step(params, cfg, batch: Dict[str, torch.Tensor], cache,
                 logits_at=None):
    """``batch["tokens"]`` (B, S); ``logits_at`` (scalar or (B,)) picks the
    position whose logits are returned (default: the last)."""
    tf.validate_family(cfg)
    return tf.prefill(params, cfg, batch["tokens"], cache,
                      logits_at=logits_at)


def decode_step(params, cfg, token: torch.Tensor, cache):
    tf.validate_family(cfg)
    return tf.decode_step(params, cfg, token, cache)
