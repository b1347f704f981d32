"""Training launcher (port of ``repro.launch.train``): a train loop with
fault tolerance, on one device or on a (data, model) mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama1_7b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama1_7b --smoke --steps 6 --mesh-shape 2x2 --backend gloo \
      --device cpu

Fault-tolerance behaviour, as in the reference:
  * resumes from the newest *valid* checkpoint (torn writes skipped);
  * the data pipeline is step-indexed, so no batch is replayed or skipped;
  * checkpoints are written by a background thread every
    ``--ckpt-every`` steps and validated by checksum at restore; the
    final save blocks;
  * straggler mitigation: a step slower than ``--step-timeout`` logs a
    straggler event.

``--device`` defaults to ``cuda``.  ``--mesh single|multi`` trains on the
production mesh (``launch.mesh.make_production_mesh``: 256 or 512 ranks,
one process each under ``torchrun``; another world size raises its
``ValueError``), ``--mesh-shape DPxTP`` on a small (data, model) mesh.
The process group comes up by ``mesh.init_distributed(--backend)``;
the model is placed by ``dist.sharding.place_model`` and the optimizer
state made on its blocks (``train.make_train_step`` on a mesh).  A
checkpoint keeps the single-device format: a save all-gathers the blocks
and only rank 0 writes; a restore reads the whole state and takes this
rank's blocks.  So a checkpoint written on a mesh restores on one device
and the other way round.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch import device as dev_lib
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api
from repro_torch.optim import OptimConfig, init_opt_state
from repro_torch.train import make_train_step


def _build_mesh(args):
    """(the mesh or None, this rank's device, whether the process group
    was brought up here)."""
    if args.mesh == "none" and not args.mesh_shape:
        return None, dev_lib.resolve(args.device), False
    created = not dist.is_initialized()
    device = mesh_lib.init_distributed(args.backend, args.device)
    if args.mesh != "none":
        try:
            mesh = mesh_lib.make_production_mesh(
                multi_pod=args.mesh == "multi", device_type=device.type)
        except ValueError:
            if created:
                dist.destroy_process_group()
            raise
        return mesh, device, created
    try:
        dp, tp = (int(v) for v in args.mesh_shape.lower().split("x"))
    except ValueError as e:
        raise SystemExit(f"--mesh-shape must be DPxTP (e.g. 2x2), got "
                         f"{args.mesh_shape!r}") from e
    if dist.get_world_size() != dp * tp:
        raise SystemExit(
            f"mesh {dp}x{tp} needs {dp * tp} ranks, the world has "
            f"{dist.get_world_size()} (run under torchrun "
            f"--nproc-per-node {dp * tp})")
    return (mesh_lib.make_debug_mesh((dp, tp), device_type=device.type),
            device, created)


def gathered_state(model, cfg, opt, mesh):
    """The single-device training state: params and AdamW moments (the
    params alone where ``opt`` is None) with every model shard
    all-gathered over "model" (a collective: every rank calls it)."""
    params = convert.param_tree(model, cfg)
    shards = [coll.model_shard(t) for t in tree_lib.tensors(params)]

    def whole(tree):
        return tree_lib.unflatten_tensors(tree, [
            t if sh is None else coll.all_gather(t, sh[0], "model", mesh)
            for t, sh in zip(tree_lib.tensors(tree), shards)])

    if opt is None:
        return {"params": whole(params)}
    return {"params": whole(params),
            "opt": opt._replace(m=whole(opt.m), v=whole(opt.v))}


def place_state(model, cfg, restored):
    """Copy a whole (single-device) restored state into the model's
    blocks; returns the optimizer state cut to the same blocks."""
    params = convert.param_tree(model, cfg)
    local = tree_lib.tensors(params)

    def block(full, like):
        sh = coll.model_shard(like)
        if sh is None:
            return full
        dim, parts, index = sh
        n = full.shape[dim] // parts
        return full.narrow(dim, index * n, n).contiguous()

    for p, r in zip(local, tree_lib.tensors(restored["params"])):
        p.copy_(block(r, p))
    opt = restored["opt"]

    def cut(tree):
        return tree_lib.unflatten_tensors(tree, [
            block(t, p) for t, p in zip(tree_lib.tensors(tree), local)])

    return opt._replace(m=cut(opt.m), v=cut(opt.v))


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
                    default="none",
                    help="the production mesh: single (16x16 data x "
                         "model) or multi (2x16x16 pod x data x model)")
    ap.add_argument("--mesh-shape", default=None,
                    help="a small DPxTP (data x model) mesh instead, e.g. "
                         "2x2; run under torchrun with DP * TP processes")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="nccl",
                    help="process-group backend of a mesh: nccl (one card "
                         "per rank) or gloo (the CPU, or ranks sharing "
                         "one card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh, dev, own_group = _build_mesh(args)
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if mesh is not None:
        say(f"[train] mesh {dctx.mesh_shape(mesh)} over "
            f"{dist.get_world_size()} ranks ({args.backend})")

    model = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    if mesh is not None:
        shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                       total_steps=args.steps)
    opt = init_opt_state(convert.param_tree(model, cfg), ocfg)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                      batch=args.batch, seed=0))
    step_fn = make_train_step(cfg, ocfg, args.microbatches)

    def state():
        if mesh is None:
            return {"params": convert.param_tree(model, cfg), "opt": opt}
        return gathered_state(model, cfg, opt, mesh)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            # the template's leaves name the checkpoint's and give their
            # dtype and device; the stored arrays are whole
            restored = mgr.restore(latest, {
                "params": convert.param_tree(model, cfg), "opt": opt})
            opt = place_state(model, cfg, restored)
            start_step = latest
            say(f"[train] resumed from step {latest}")

    def save(step, blocking):
        st = state()
        if rank0:
            mgr.save(step, st, blocking=blocking)

    with dctx.use_mesh(mesh):
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {"tokens": data.batch_at(step)}
            if cfg.modality == "vision":
                P = max(int(args.seq_len * cfg.prefix_frac), 1)
                batch = {"tokens": data.batch_at(step)[:, P:],
                         "prefix_embeds": torch.zeros(
                             (args.batch, P, cfg.d_model),
                             dtype=torch.float32)}
            elif cfg.family == "encdec":
                batch["frames"] = torch.zeros(
                    (args.batch, args.seq_len, cfg.d_model),
                    dtype=torch.float32)
            model, opt, metrics = step_fn(model, opt, batch)
            loss = float(metrics["loss"])        # the step's one host sync
            dt = time.time() - t0
            if dt > args.step_timeout:
                say(f"[train][straggler] step {step} took {dt:.1f}s "
                    f"(> {args.step_timeout}s)")
            if step % 10 == 0 or step == args.steps - 1:
                say(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            if mgr and (step + 1) % args.ckpt_every == 0:
                save(step + 1, blocking=False)
        if mgr:
            if rank0:
                mgr.wait()
            save(args.steps, blocking=True)
    if mesh is not None:
        dist.barrier()
    say("[train] done")
    if own_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
