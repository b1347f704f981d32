"""Mesh construction (port of ``repro.launch.mesh``).

One process per rank: the process group comes up from ``torchrun``'s
environment (``init_distributed``), then a ``DeviceMesh`` names its dims
("data", "model").  Functions, not module constants, so importing this
module never touches the process group.

The backend is an explicit argument, never chosen by catching a failure:
``nccl`` for one GPU per rank, ``gloo`` on the CPU and where ranks share
one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, device="cuda") -> torch.device:
    """Bring up the default process group from ``torchrun``'s environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) with
    ``backend``, and return this rank's device: ``cuda:LOCAL_RANK`` for
    nccl (one card per rank), the one card for gloo on CUDA, the CPU for
    ``device="cpu"``.  A group already up is kept."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("nccl needs CUDA tensors; use gloo on the CPU")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if backend == "nccl" else (dev.index or 0))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return dev


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(
            f"the production mesh {shape} {axes} needs a world of {want} "
            f"ranks, this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Tuple[str, ...] = ("data", "model"),
                    device_type: str = "cpu") -> DeviceMesh:
    """A small mesh over the current world (its size must be the shape's
    product): spawned test ranks, or a few ranks on one card."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _local_rank_main(rank: int, fn, world: int, backend: str, device: str,
                     store: str, args) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        # nccl: a card a rank; gloo: the ranks share the given card
        dev = torch.device("cuda", rank if backend == "nccl"
                           else (dev.index or 0))
        torch.cuda.set_device(dev)
    # the ranks share the host's cores: one rank's intra-op threads each
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, f"{store}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_local(fn, world: int, *args, backend: str = "gloo",
              device: str = "cpu", workdir: str = None):
    """Run ``fn(rank, world, device, *args)`` in ``world`` local processes
    (``torch.multiprocessing`` spawn, a file store under ``workdir``),
    each with the default process group up on ``backend``; returns the
    ranks' return values (``torch.save``-able), in rank order.  A rank
    that raises makes this raise.  ``fn`` must be importable by name."""
    import tempfile

    import torch.multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(_local_rank_main, args=(fn, world, backend, device, store,
                                         args), nprocs=world, join=True)
        return [torch.load(f"{store}.rank{r}.pt", weights_only=False)
                for r in range(world)]
