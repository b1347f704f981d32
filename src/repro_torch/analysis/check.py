"""Contract-checker CLI: ``python -m repro_torch.analysis.check`` (port of
``repro.analysis.check``).

Builds a small random-init model per named config (quantizing it where
the config says so), stands up a serving engine, and runs the
step-artifact + trace rules against one profiled decode step; ``--ast``
additionally (or instead) runs the AST rules over source trees.  Emits a
human report per subject and an aggregate JSON document with ``--json``;
exit code 1 iff any subject has ERROR-severity findings.

Configs are the reference's (deliberately tiny: the smoke-scale
llama1_7b, vocab 128, 2 layers; qwen3_moe_30b_a3b, vocab 64, 1 layer) —
the point is the step's op structure, which does not change with model
scale.  ``--device`` picks the card (default) or the CPU.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

from .ast_rules import AST_RULES, ast_context
from .core import Report, run_rules


def _build_engine(config: str, device="cuda"):
    """Quantize the smoke model per the named config and wrap it in a
    serving engine (import-heavy, so deferred out of module scope)."""
    import torch

    from repro_torch import device as dev_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import APConfig, CLAQConfig, ORConfig
    from repro_torch.data import calibration_set
    from repro_torch.launch.quantize import claq_quantize
    from repro_torch.models import api
    from repro_torch.serve.engine import ServingEngine

    device = dev_lib.resolve(device)
    if config == "moe":
        cfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"),
                                  vocab=64, n_layers=1)
    else:
        cfg = dataclasses.replace(get_smoke_config("llama1_7b"),
                                  vocab=128, n_layers=2)
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    if config in ("dense", "moe"):
        return ServingEngine(params, cfg, n_slots=2, max_len=32,
                             prepare=False, device=device), None
    if config == "ap_or":
        qcfg = CLAQConfig(bits=2, method="kmeans", kmeans_iters=4,
                          gptq_blocksize=32, ap=APConfig(2.2, 2, 4),
                          orr=ORConfig(0.1))
    elif config == "int3":
        qcfg = CLAQConfig(bits=3, method="kmeans", kmeans_iters=4,
                          gptq_blocksize=32)
    else:
        raise SystemExit(f"unknown config {config!r} "
                         f"(expected dense | moe | ap_or | int3)")
    calib = calibration_set(vocab=cfg.vocab, n_segments=4,
                            seq_len=32).to(device)
    qparams, _ = claq_quantize(copy.deepcopy(params), cfg, calib, qcfg)
    eng = ServingEngine(qparams, cfg, n_slots=2, max_len=32, device=device)
    dense_eng = ServingEngine(params, cfg, n_slots=2, max_len=32,
                              prepare=False, device=device)
    return eng, dense_eng


def check_config(config: str, device="cuda") -> Report:
    from .artifacts import verify_engine
    eng, dense_eng = _build_engine(config, device)
    return verify_engine(eng, dense_eng, raise_on_error=False,
                         subject=f"config:{config}")


def check_ast(paths: List[str]) -> Report:
    ctx = ast_context([Path(p) for p in paths])
    return run_rules(AST_RULES, ctx,
                     subject="ast:" + ",".join(str(p) for p in paths))


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Run the hot-path contract checker.")
    ap.add_argument("--config", action="append", default=[],
                    help="engine config to profile and lint "
                         "(dense | moe | ap_or | int3); repeatable")
    ap.add_argument("--ast", action="append", default=[], metavar="PATH",
                    help="run the AST rules over this file/dir; "
                         "repeatable")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="write the aggregate JSON report here ('-' = "
                         "stdout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the config engines (default "
                         "cuda; 'cpu' runs K1's plain version)")
    args = ap.parse_args(argv)
    if not args.config and not args.ast:
        ap.error("nothing to check: pass --config and/or --ast")

    reports: List[Report] = []
    if args.ast:
        reports.append(check_ast(args.ast))
    for config in args.config:
        reports.append(check_config(config, args.device))

    for rep in reports:
        print(rep.render())
    doc: Dict[str, Any] = {
        "clean": all(r.clean for r in reports),
        "reports": [r.to_json() for r in reports],
    }
    if args.json == "-":
        json.dump(doc, sys.stdout, indent=2, default=str)
        print()
    elif args.json:
        Path(args.json).write_text(
            json.dumps(doc, indent=2, default=str) + "\n")
    return 0 if doc["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
