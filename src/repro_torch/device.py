"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist (there is
    no silent fallback to the CPU — pass ``device="cpu"`` for that)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return d
