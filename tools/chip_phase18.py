#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone (seamless_m4t_medium on two ranks
sharing one NVIDIA card), on one or more seeds, after building K1.

    python3 tools/chip_phase18.py [--seeds 0 7]

Each seed's card generator draws phase 18's frames and prompt tokens
(the script's own come from its running generator) and runs
``phase_encdec_mesh`` on them, as ``chip_phase16.py`` does for phase 16;
records to ``build/phase18/seed<N>.json`` (gitignored); exits non-zero
if a seed failed.  18c's production cells (a few minutes of host time on
meta tensors) are traced once, in a CPU process started with the first
seed and collected by the last.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_phase16  # noqa: E402


class Phase18:
    """``chip_phase16.run``'s call for each of ``n_seeds`` seeds."""

    def __init__(self, n_seeds: int):
        self.left, self.cells = n_seeds, None

    def __call__(self, C, prompts, gen):
        from repro_torch.kernels import dequant_matmul as dm
        from repro_torch.kernels import ops, plan
        from repro_torch.models import api
        if self.cells is None:
            self.cells = C.start_encdec_cells()
        self.left -= 1
        return C.phase_encdec_mesh(api, dm, ops, plan, gen,
                                   cells=self.cells if self.left == 0
                                   else False)


if __name__ == "__main__":
    seeds = argparse.ArgumentParser(add_help=False)
    seeds.add_argument("--seeds", type=int, nargs="+", default=[0])
    n = len(seeds.parse_known_args()[0].seeds)
    sys.exit(chip_phase16.run(None, 18, Phase18(n)))
