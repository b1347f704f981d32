"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic, async, self-validating, in the reference's on-disk format, so
either package restores what the other wrote.

  * **format** — ``step_<step:010d>/arrays.npz`` holds one array per leaf
    under ``leaf_{i:05d}``; ``manifest.json`` maps each leaf's
    ``jax.tree_util.keystr`` name (``repro_torch.tree`` names leaves
    alike, e.g. ``['params']['blocks']['attn']['q']['kernel']``,
    ``['opt'].m[...]``) to its key, shape, dtype and a CRC32 of the
    stored bytes; ``extra`` carries static meta (stripe bits, shapes).
    bfloat16 is stored as a uint8 view with the dtype string
    ``"bfloat16"``, written and read without numpy knowing the type.
    A ``tree.LayerStack`` leaf is stacked on a leading layer axis on save
    and split on restore.
  * **atomic** — writes go to ``<step>.tmp/`` and are renamed into place
    only after the manifest is fsynced.
  * **async** — ``save(..., blocking=False)`` copies the leaves to the
    host in the caller's thread (a copy also for a leaf already there),
    then a background thread writes them: training goes on, updating its
    tensors in place, while the disk works.  A write that failed raises
    at the next ``wait()``.
  * **self-validating** — ``latest_step()`` walks back past torn or
    corrupt steps; ``restore()`` re-verifies every leaf and raises
    ``CheckpointCorrupt`` naming the leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

_BF16 = "bfloat16"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype string): bf16 as its uint16 bit pattern.  Always
    a copy, also of a CPU tensor: an async save must not hand its writer
    the live storage that later steps update in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def _leaf_to_host(leaf) -> Tuple[np.ndarray, str]:
    """(contiguous host array, dtype string); a scalar becomes shape (1,),
    as the reference's ``np.ascontiguousarray`` stores it."""
    if isinstance(leaf, tree_lib.LayerStack):
        parts = [_host(t) for t in leaf]
        return np.stack([a for a, _ in parts]), parts[0][1]
    a, dtype_str = (_host(leaf) if isinstance(leaf, torch.Tensor)
                    else (np.array(leaf), str(np.asarray(leaf).dtype)))
    return np.ascontiguousarray(a), dtype_str


def _to_torch(arr: np.ndarray, dtype_str: str, like: torch.Tensor
              ) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype and shape (a scalar
    is stored as shape (1,)) on its device.  Integers of one width cross
    by their bits (the reference's uint32 planes are the port's int32
    ones)."""
    if dtype_str == _BF16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif arr.dtype.kind == "u" and like.dtype in (torch.int32, torch.int64,
                                                  torch.int16, torch.int8) \
            and arr.dtype.itemsize == like.element_size():
        t = torch.from_numpy(arr.view(arr.dtype.str.replace("u", "i")).copy())
    else:
        t = torch.from_numpy(np.array(arr))
    if like.dim() == 0 and t.shape == (1,):
        t = t.reshape(())
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointCorrupt(RuntimeError):
    """A stored leaf's content hash disagrees with the manifest written at
    save time.  ``leaf`` names the offending pytree path."""

    def __init__(self, message: str, leaf: str, step: int):
        super().__init__(message)
        self.leaf = leaf
        self.step = step


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True,
             extra: Optional[Dict] = None):
        """state: a ``repro_torch.tree`` of tensors / arrays (params, opt
        state, cursors).  Fails before writing if the disk is short."""
        host = [(name, *_leaf_to_host(leaf))
                for name, leaf in tree_lib.flatten(state)]
        need = sum(a.nbytes for _, a, _ in host)
        free = shutil.disk_usage(self.directory).free
        if need + (64 << 20) > free:
            raise OSError(
                f"checkpoint step {step} needs {need / 1e9:.2f} GB and "
                f"{self.directory} has {free / 1e9:.2f} GB free")
        if blocking:
            self._write(step, host, extra)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, extra),
                daemon=True)
            self._thread.start()

    def pending(self) -> bool:
        """Whether an async write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step, host, extra):
        try:
            self._write(step, host, extra)
        except BaseException as e:   # surfaced by wait()
            self._error = e

    def _write(self, step: int, host: List, extra):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "shard": 0, "num_shards": 1,
                    "extra": extra or {}, "leaves": {}}
        arrays = {}
        for i, (name, arr, dtype_str) in enumerate(host):
            key = f"leaf_{i:05d}"
            stored = arr.view(np.uint8) if dtype_str == _BF16 else arr
            if stored.dtype.kind not in "biufc":   # other ml_dtypes arrays
                stored = arr.view(np.uint8)
            arrays[key] = stored
            manifest["leaves"][name] = {
                "key": key, "shape": list(arr.shape), "dtype": dtype_str,
                "crc": _crc(stored)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self._list_steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _list_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return out

    def _valid(self, step: int) -> bool:
        path = os.path.join(self.directory, f"step_{step:010d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                for info in manifest["leaves"].values():
                    if _crc(z[info["key"]]) != info["crc"]:
                        return False
            return True
        except Exception:
            return False

    def latest_step(self) -> Optional[int]:
        for s in sorted(self._list_steps(), reverse=True):
            if self._valid(s):
                return s
        return None

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.directory, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template: Any) -> Any:
        """A tree shaped as ``template`` filled (by leaf name) from the
        checkpoint, each leaf in its template leaf's dtype and on its
        device, after verifying its content hash against the manifest —
        a mismatch raises ``CheckpointCorrupt`` naming the leaf."""
        manifest = self.manifest(step)
        path = os.path.join(self.directory, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            def one(name, leaf):
                if name not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {name}")
                info = manifest["leaves"][name]
                arr = z[info["key"]]
                # the CRC covers the STORED bytes (a u8 view for bf16)
                if _crc(arr) != info["crc"]:
                    raise CheckpointCorrupt(
                        f"checkpoint step {step}: stored bytes of leaf "
                        f"{name} do not match the manifest content hash "
                        f"(crc {_crc(arr)} != {info['crc']}) — refusing "
                        f"to serve a corrupted plane", leaf=name, step=step)
                dtype_str = info["dtype"]
                if dtype_str == _BF16:
                    arr = arr.view(np.uint16).reshape(info["shape"])
                elif str(arr.dtype) != dtype_str:
                    arr = arr.view(np.dtype(dtype_str)).reshape(
                        info["shape"])
                if isinstance(leaf, tree_lib.LayerStack):
                    return tree_lib.LayerStack(
                        _to_torch(arr[i], dtype_str, t)
                        for i, t in enumerate(leaf))
                if isinstance(leaf, torch.Tensor):
                    return _to_torch(arr, dtype_str, leaf)
                if dtype_str == _BF16:
                    raise TypeError(f"leaf {name}: restore bf16 into a "
                                    f"torch tensor template")
                return np.asarray(arr).astype(np.asarray(leaf).dtype)
            return tree_lib.map_with_name(one, template)

    def restore_latest(self, template: Any):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.restore(s, template)
