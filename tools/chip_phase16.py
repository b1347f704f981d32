#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone (the moe family and MLA with
experts on two ranks sharing one NVIDIA card), on one or more prompt
sets, after building K1.

    python3 tools/chip_phase16.py [--seeds 0 7]

Each seed draws phase 4's prompt lengths (``chip_smoke.PROMPT_LENS``)
from a host generator of that seed and runs ``phase_moe_mesh`` on them:
the same checks and readings as in the whole script (whose own prompts
come from its phase 4).  Writes each seed's record to
``build/phase16/seed<N>.json`` (gitignored); exits non-zero if a seed
failed.  ``run`` does the same for another phase (``chip_phase17.py``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def run(argv, phase: int, call) -> int:
    """Build K1, then per ``--seeds`` seed ``call(chip_smoke, prompts,
    gen)`` (phase ``phase`` of the script, on that seed's prompts);
    records to ``build/phase<phase>/seed<N>.json``."""
    ap = argparse.ArgumentParser(
        description=f"phase {phase} of chip_smoke.py alone")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"chip_phase{phase}: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    import chip_smoke as C
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = cuda_build.load("dequant_matmul.cu")
    print(f"built in {built.seconds:.1f} s", flush=True)
    out = REPO / "build" / f"phase{phase}"
    out.mkdir(parents=True, exist_ok=True)
    ok = True
    for seed in args.seeds:
        host_gen = torch.Generator().manual_seed(seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        prompts = [torch.randint(1, 32000, (n,), generator=host_gen).tolist()
                   for n in C.PROMPT_LENS]
        try:
            res = call(C, prompts, gen)
            (out / f"seed{seed}.json").write_text(
                json.dumps(res, indent=1, default=str))
        except Exception:
            traceback.print_exc()
            ok = False
        print(f"seed {seed} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0 if ok else 1


def phase16(C, prompts, gen):
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine
    return C.phase_moe_mesh(api, dm, ServingEngine, prompts)


if __name__ == "__main__":
    sys.exit(run(None, 16, phase16))
