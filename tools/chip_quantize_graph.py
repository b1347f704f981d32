#!/usr/bin/env python3
"""The card's CLAQ quantizer with its GPTQ column loop run eagerly and
replayed from CUDA graphs, on full-width llama1_7b matrix shapes (seeded
Gaussian weights, a full-rank Hessian from 16384 Gaussian rows) and
``chip_smoke.py`` phase 8's recipe (K-Means, 6 iterations, blocksize 32,
AP 2.2): seconds per matrix for each, and the two results held equal bit
for bit.

    python3 tools/chip_quantize_graph.py [--shapes 4096x4096 4096x11008]

Prints the card's name and power limit, one JSON line per shape, and
exits non-zero if the two runs differ or no card is present.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def timed_quantize(claq, W, H, qcfg, plan, graph):
    from repro_torch.core import gptq
    inner = gptq.gptq_quantize_matrix

    def call(*a, **k):
        return inner(*a, cuda_graph=graph, **k)

    gptq.gptq_quantize_matrix = call
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qt, Q, stats = claq.quantize_matrix(W, H, qcfg, plan)
        torch.cuda.synchronize()
        return Q, stats, time.perf_counter() - t0
    finally:
        gptq.gptq_quantize_matrix = inner


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+",
                    default=["4096x4096", "4096x11008"],
                    help="rows x cols (out x in) of each matrix")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_quantize_graph: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import APConfig, CLAQConfig
    from repro_torch.core import claq
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=6,
                      gptq_blocksize=32, ap=APConfig(2.2, 2, 4))
    ok = True
    for i, shape in enumerate(args.shapes):
        rows, cols = map(int, shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(i)
        W = torch.randn((rows, cols), device="cuda", generator=gen) * 0.02
        X = torch.randn((16384, cols), device="cuda", generator=gen)
        H = 2.0 * (X.T @ X) / X.shape[0]
        del X
        plan = claq.plan_matrix(W, qcfg)
        Qe, se, eager_s = timed_quantize(claq, W, H, qcfg, plan, False)
        Qg, sg, graph_s = timed_quantize(claq, W, H, qcfg, plan, True)
        equal = bool(torch.equal(Qe, Qg))
        ok &= equal
        print(json.dumps(dict(shape=shape, eager_s=eager_s, graph_s=graph_s,
                              speedup=eager_s / graph_s, bitwise_equal=equal,
                              proxy_loss=[se.proxy_loss, sg.proxy_loss])),
              flush=True)
        del W, H, Qe, Qg
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
