#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone (rwkv6_7b and zamba2_1p2b on two
ranks sharing one NVIDIA card), on one or more prompt sets, after
building K1.

    python3 tools/chip_phase17.py [--seeds 0 7]

Each seed draws phase 4's prompt lengths from a host generator of that
seed and runs ``phase_recurrent_mesh`` on them, as ``chip_phase16.py``
does for phase 16; records to ``build/phase17/seed<N>.json``
(gitignored); exits non-zero if a seed failed.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_phase16  # noqa: E402


def phase17(C, prompts, gen):
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops, plan
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine
    return C.phase_recurrent_mesh(api, dm, ops, plan, ServingEngine,
                                  prompts, gen)


if __name__ == "__main__":
    sys.exit(chip_phase16.run(None, 17, phase17))
