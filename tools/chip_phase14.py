#!/usr/bin/env python3
"""Phase 14 (b-f) of ``chip_smoke.py`` alone (llama1_7b on two ranks
sharing one NVIDIA card: the (1, 2) and (2, 1) meshes, two pods, a page
pool split over "dp", the row-sharded quantizer, shard-local K1), on one
or more prompt sets, after building K1.

    python3 tools/chip_phase14.py [--seeds 0 7]

Each seed draws phase 4's prompt lengths from a host generator of that
seed and runs ``phase_distribution`` on them, as ``chip_phase16.py``
does for phase 16; records to ``build/phase14/seed<N>.json``
(gitignored); exits non-zero if a seed failed.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_phase16  # noqa: E402


def phase14(C, prompts, gen):
    import torch
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops, plan
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine
    return C.phase_distribution(api, dm, ops, plan, ServingEngine, prompts,
                                gen, torch.Generator().manual_seed(1))


if __name__ == "__main__":
    sys.exit(chip_phase16.run(None, 14, phase14))
