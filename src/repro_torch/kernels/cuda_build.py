"""Build and load the port's CUDA kernels.

Each library is one or more sources under ``repro_torch/csrc/``, compiled
by ``nvcc`` for ``sm_90a`` in parallel (one process per source) and linked
into a shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first CUDA use, never at import, into
``<repo>/build/kernels/`` (listed in ``.gitignore``); the library's file
name carries a hash of its sources and of every header under ``csrc/``
that they include (``#include "..."``, followed recursively), so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = ("-shared",)
# a library's sources beyond the one it is named after: K1's kernels are
# compiled one bit-width per source
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "dequant_matmul.cu": tuple(f"dequant_bits{b}.cu" for b in (1, 2, 3, 4, 8)),
}


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc's output (ptxas registers / shared memory)


_BUILT: Dict[str, Built] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(source: str, csrc: Path = CSRC) -> List[Path]:
    """``csrc/<source>`` and every file under ``csrc`` it includes with
    ``#include "..."``, recursively, in a fixed order."""
    seen: List[Path] = []
    todo = [csrc / source]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.is_file():
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return seen


def library_sources(source: str) -> Tuple[str, ...]:
    """The sources linked into the library named after ``source``."""
    return (source,) + LIBRARIES.get(source, ())


def digest(source: str, csrc: Path = CSRC) -> str:
    """Hash of the library's sources, the headers they include and the
    nvcc flags."""
    h = hashlib.sha256()
    seen: List[Path] = []
    for src in library_sources(source):
        for path in sources(src, csrc):
            if path not in seen:
                seen.append(path)
                h.update(path.name.encode() + b"\0" + path.read_bytes()
                         + b"\0")
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:12]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def load(source: str) -> Built:
    """Compile the library named after ``csrc/<source>`` (once per process
    and digest) and return it loaded.  Raises on a failed build."""
    if source in _BUILT:
        return _BUILT[source]
    out = BUILD_DIR / f"{Path(source).stem}-{digest(source)}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in library_sources(source):
            obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [_nvcc(), *COMPILE_FLAGS, "-o", str(obj), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            text = proc.communicate()[0]
            log.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src} (rc={proc.returncode}):\n{text}")
        tmp = out.with_name(f"{tag}.so.tmp")
        if not failed:
            link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link (rc={link.returncode}):\n"
                              f"{link.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log_path.write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {source}: "
                               + "\n".join(failed))
        os.replace(tmp, out)        # atomic: concurrent builds agree
    log = log_path.read_text() if log_path.exists() else ""
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _BUILT[source] = built
    return built
