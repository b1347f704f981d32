"""Training launcher (port of ``repro.launch.train``): a train loop with
fault tolerance, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama1_7b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

Fault-tolerance behaviour, as in the reference:
  * resumes from the newest *valid* checkpoint (torn writes skipped);
  * the data pipeline is step-indexed, so no batch is replayed or skipped;
  * checkpoints are written by a background thread every
    ``--ckpt-every`` steps and validated by checksum at restore; the
    final save blocks;
  * straggler mitigation: a step slower than ``--step-timeout`` logs a
    straggler event.

``--device`` defaults to ``cuda``.  ``--mesh`` other than ``none`` raises:
the port's distribution layer serves and quantizes on a mesh, and the
sharded train step is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import convert
from repro_torch import device as dev_lib
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.models import api
from repro_torch.optim import OptimConfig, init_opt_state
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--step-timeout", type=float, default=300.0)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port's distribution layer serves "
            "and quantizes on a mesh; a sharded train step is not ported "
            "yet (ROADMAP.md, Queue 1, item 7): train on one device with "
            "--mesh none")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = dev_lib.resolve(args.device)

    model = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    ocfg = OptimConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                       total_steps=args.steps)
    opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                      batch=args.batch, seed=0))
    step_fn = make_train_step(cfg, ocfg, args.microbatches)

    def state():
        return {"params": convert.param_tree(model, cfg), "opt": opt}

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(latest, state())
            tree_lib.copy_into(convert.param_tree(model, cfg),
                               restored["params"])
            opt = restored["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}")

    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = {"tokens": data.batch_at(step)}
        if cfg.modality == "vision":
            P = max(int(args.seq_len * cfg.prefix_frac), 1)
            batch = {"tokens": data.batch_at(step)[:, P:],
                     "prefix_embeds": torch.zeros(
                         (args.batch, P, cfg.d_model), dtype=torch.float32)}
        elif cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (args.batch, args.seq_len, cfg.d_model), dtype=torch.float32)
        model, opt, metrics = step_fn(model, opt, batch)
        loss = float(metrics["loss"])        # the step's one host sync
        dt = time.time() - t0
        if dt > args.step_timeout:
            print(f"[train][straggler] step {step} took {dt:.1f}s "
                  f"(> {args.step_timeout}s)")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state(), blocking=False)
    if mgr:
        mgr.wait()
        mgr.save(args.steps, state(), blocking=True)
    print("[train] done")


if __name__ == "__main__":
    main()
