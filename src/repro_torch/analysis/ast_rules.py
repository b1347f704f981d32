"""Repo-level AST rules over the port's Python source (port of
``repro.analysis.ast_rules``; its framework — ``_File``, the suppression
comment and ``ast_context`` — is the reference's).

These rules parse files with the stdlib ``ast`` module — no imports of
the code under scan — and enforce the serving hygiene contracts that no
single step trace shows:

  * AST-IM1: no device work at import time.  Module-scope tensor creation
    (``torch.zeros``, ``torch.tensor``, ...), ``torch.cuda.*`` and
    ``.cuda()`` / ``.to(...)`` allocate memory and initialise a device
    before the caller picks one.
  * AST-JT1: no Python side effects inside the step bodies: no
    ``global``/``nonlocal`` write (except the registered launch counters)
    and no ``print``.  The reference scopes this to its jitted functions;
    the port has none, so it scopes it to ``STEP_BODIES``, the functions
    the engine runs every step.
  * AST-HS1: no host sync inside the step bodies: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``float()`` / ``int()`` /
    ``bool()`` of a possibly-tensor value block the host on the device.
    The engine's ``to_host`` helper is the one sanctioned transfer.
  * AST-DT1: deterministic serve paths take no wall-clock and no unseeded
    RNG (``torch.rand``/``randn``/``randint``/``randperm`` without
    ``generator=`` included); ``repro_torch/serve/telemetry.py`` is the one
    sanctioned clock source.

Suppression: a line ending in a comment containing ``contract: ok``
(e.g. ``# contract: ok — eager path``) is exempt from all AST rules;
suppressions are collected per file before the AST walk since ``ast``
drops comments.
"""
from __future__ import annotations

import ast
import io
import tokenize
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .core import Finding, Rule, Severity, register

# The functions the engine runs each step (model forwards, prefill and
# decode, the quantized matmul dispatch and K1's wrapper), by file.  A
# function listed here is scanned with everything nested in it.
STEP_BODIES: Dict[str, Tuple[str, ...]] = {
    "repro_torch/models/api.py": ("prefill_step", "decode_step",
                                  "decode_span"),
    "repro_torch/models/transformer.py": (
        "block_apply", "_shared_attention", "_apply", "forward", "prefill",
        "decode_step", "decode_span"),
    "repro_torch/models/layers.py": (
        "select_logits", "rope_angles", "apply_rope", "blocked_attention",
        "paged_write_ids", "pool_write", "pool_view", "pack_bytes",
        "unpack_bytes", "exchange_rows", "placed_pool_write",
        "placed_pool_view", "paged_pools", "_span_write",
        "gqa_attention", "_decode_attention", "_decode_rows",
        "_span_decode_attention", "swiglu_mlp", "gelu_mlp"),
    "repro_torch/models/modules.py": ("dense", "out_block", "gather_out",
                                      "materialize_kernel", "rms_norm",
                                      "layer_norm", "embed"),
    "repro_torch/models/mla.py": (
        "_project_q", "_latent_kv", "mla_attention", "head_block",
        "_output", "_expanded", "_absorbed_weights", "_absorbed_rows",
        "_absorbed_decode", "_absorbed_span"),
    "repro_torch/models/moe.py": ("expert_weight", "top_k", "capacity",
                                  "_dp_rows", "moe_mlp", "_routed"),
    "repro_torch/models/rwkv6.py": ("_token_shift", "_wkv_chunked",
                                    "time_mix", "channel_mix"),
    "repro_torch/models/mamba2.py": ("_conv_apply", "_ssd_chunked",
                                     "mamba_block"),
    "repro_torch/kernels/ops.py": ("quantize_activations", "group_calls",
                                   "gather_shards", "prepared_qmatmul",
                                   "qmatmul"),
    "repro_torch/kernels/dequant_matmul.py": ("dequant_matmul", "take_fill",
                                              "dequant_matmul_plain"),
    "repro_torch/serve/engine.py": ("_decode_batch", "_sample", "to_host",
                                    "to_device"),
}

# Module state the step bodies may mutate: K1's launch counters (and the
# plain version's dispatch count), bumped once a launch by design.
REGISTERED_COUNTERS: Tuple[str, ...] = (
    "launch_count", "int8_launch_count", "aligned_launch_count",
    "plain_count")

# The step's sanctioned device-to-host transfer (AST-HS1's exception): the
# engine's helper, which the op trace counts (HLO-HT1: one a step).
SANCTIONED_TRANSFERS: Tuple[str, ...] = ("to_host",)


def _counter_ok(name: str) -> bool:
    return name in REGISTERED_COUNTERS


def _dotted(node: ast.AST) -> str:
    """Render an attribute/name chain like ``torch.cuda.synchronize``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _suppressed_lines(source: str) -> Set[int]:
    out: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT and "contract: ok" in tok.string:
                out.add(tok.start[0])
    except tokenize.TokenError:
        pass
    return out


def _step_functions(tree: ast.Module, path: Path,
                    bodies: Dict[str, Tuple[str, ...]]
                    ) -> List[ast.FunctionDef]:
    """The step bodies of one file (outermost listed function of each
    nest; nested functions are scanned with it)."""
    fpath = str(path).replace("\\", "/")
    names: Set[str] = set()
    for suffix, fns in bodies.items():
        if fpath.endswith(suffix):
            names.update(fns)
    out: List[ast.FunctionDef] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if (isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and child.name in names):
                out.append(child)
            else:
                visit(child)
    if names:
        visit(tree)
    return out


class _File:
    """Parsed unit handed to each AST rule."""

    def __init__(self, path: Path, source: str,
                 bodies: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.suppressed = _suppressed_lines(source)
        self.steps = _step_functions(self.tree, path,
                                     STEP_BODIES if bodies is None
                                     else bodies)

    def loc(self, node: ast.AST) -> str:
        return f"{self.path}:{getattr(node, 'lineno', '?')}"

    def ok(self, node: ast.AST) -> bool:
        return getattr(node, "lineno", -1) in self.suppressed


def _iter_files(paths: Iterable[Path],
                bodies: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> List[_File]:
    out: List[_File] = []
    for root in paths:
        root = Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for p in files:
            try:
                out.append(_File(p, p.read_text(), bodies))
            except (SyntaxError, UnicodeDecodeError, OSError):
                continue
    return out


_TENSOR_CREATION = tuple(f"torch.{n}" for n in (
    "zeros", "ones", "empty", "full", "tensor", "as_tensor", "arange",
    "linspace", "eye", "rand", "randn", "randint", "randperm", "zeros_like",
    "ones_like", "empty_like", "full_like", "from_numpy"))
_DEVICE_PREFIXES = ("torch.cuda.",)
_DEVICE_METHODS = ("cuda", "to")


class NoImportTimeDeviceWork(Rule):
    id = "AST-IM1"
    severity = Severity.ERROR
    invariant = ("no module-scope tensor creation, torch.cuda.* or "
                 ".cuda()/.to(device): import must not allocate memory or "
                 "initialise a device before the caller picks one")
    origin = "PR 3"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        files: Optional[List[_File]] = ctx.get("files")
        if files is None:
            return None
        out: List[Finding] = []
        for f in files:
            for node in self._module_scope_calls(f.tree):
                if f.ok(node):
                    continue
                name = _dotted(node.func)
                method = (node.func.attr
                          if isinstance(node.func, ast.Attribute) else "")
                if (name in _TENSOR_CREATION
                        or name.startswith(_DEVICE_PREFIXES)
                        or (method in _DEVICE_METHODS
                            and not name.startswith("torch."))):
                    shown = name or f".{method}"
                    out.append(self.finding(
                        f"device work at import time: {shown}(...)",
                        subject=f.loc(node), call=shown))
        return out

    @staticmethod
    def _module_scope_calls(tree: ast.Module) -> List[ast.Call]:
        """Calls at module scope, descending into if/try blocks but not
        into function or class-method bodies (class-level constants DO
        execute at import, so descend into ClassDef)."""
        out: List[ast.Call] = []
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                out.append(node)
            stack.extend(ast.iter_child_nodes(node))
        return out


class NoJitSideEffects(Rule):
    id = "AST-JT1"
    severity = Severity.ERROR
    invariant = ("no Python side effects inside the step bodies except "
                 "the registered launch counters: a global/nonlocal write "
                 "or a print runs on every step")
    origin = "PR 2"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        files: Optional[List[_File]] = ctx.get("files")
        if files is None:
            return None
        out: List[Finding] = []
        for f in files:
            for fn in f.steps:
                out.extend(self._scan_fn(f, fn))
        return out

    def _scan_fn(self, f: _File, fn: ast.FunctionDef) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(fn):
            if f.ok(node):
                continue
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                bad = [n for n in node.names if not _counter_ok(n)]
                if bad:
                    out.append(self.finding(
                        f"global/nonlocal write to {bad} inside step body "
                        f"{fn.name}() (only registered launch counters "
                        f"may be bumped)",
                        subject=f.loc(node), names=bad, fn=fn.name))
            elif isinstance(node, ast.Call):
                if _dotted(node.func) == "print":
                    out.append(self.finding(
                        f"print() inside step body {fn.name}()",
                        subject=f.loc(node), fn=fn.name))
        return out


_HOST_SYNC_BUILTINS = ("float", "int", "bool")
_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


class NoHostSyncInJit(Rule):
    id = "AST-HS1"
    severity = Severity.ERROR
    invariant = ("no .item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() "
                 "of a tensor inside the step bodies: a host sync blocks "
                 "the host on the device (the engine's to_host is the one "
                 "sanctioned transfer)")
    origin = "PR 6"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        files: Optional[List[_File]] = ctx.get("files")
        if files is None:
            return None
        out: List[Finding] = []
        for f in files:
            for fn in f.steps:
                if fn.name in SANCTIONED_TRANSFERS:
                    continue
                static = self._static_names(fn)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call) or f.ok(node):
                        continue
                    name = _dotted(node.func)
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _HOST_SYNC_METHODS
                            and not node.args and not node.keywords):
                        out.append(self.finding(
                            f".{node.func.attr}() inside step body "
                            f"{fn.name}()",
                            subject=f.loc(node), fn=fn.name,
                            method=node.func.attr))
                        continue
                    if (name in _HOST_SYNC_BUILTINS and len(node.args) == 1
                            and self._traced_operand(node.args[0], static)):
                        out.append(self.finding(
                            f"{name}() on a possibly-tensor value inside "
                            f"step body {fn.name}()",
                            subject=f.loc(node), fn=fn.name, builtin=name))
        return out

    @staticmethod
    def _static_names(fn: ast.FunctionDef) -> Set[str]:
        """Names that hold host values: any name fed from ``.shape`` /
        ``len()`` / constants within the function (heuristic: we only need
        to avoid false positives on shape math)."""
        static: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                names: List[str] = []
                if isinstance(tgt, ast.Name):
                    names = [tgt.id]
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    names = [e.id for e in tgt.elts
                             if isinstance(e, ast.Name)]
                if names and NoHostSyncInJit._static_expr(node.value):
                    static.update(names)
        return static

    @staticmethod
    def _static_expr(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in (
                "shape", "ndim", "dtype", "size"):
            return True
        if isinstance(node, ast.Call):
            if _dotted(node.func) == "len":
                return True
            # t.size(d), t.dim(), t.numel(), t.element_size(): host ints
            return (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("size", "dim", "numel",
                                           "element_size"))
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.BinOp):
            return (NoHostSyncInJit._static_expr(node.left)
                    and NoHostSyncInJit._static_expr(node.right))
        if isinstance(node, ast.Subscript):
            return NoHostSyncInJit._static_expr(node.value)
        return False

    @staticmethod
    def _traced_operand(node: ast.AST, static: Set[str]) -> bool:
        """True when the operand may be a tensor: not a literal, not shape
        arithmetic, not a name previously assigned from shape math."""
        if NoHostSyncInJit._static_expr(node):
            return False
        if isinstance(node, ast.Name):
            return node.id not in static
        if isinstance(node, ast.BinOp):
            return (NoHostSyncInJit._traced_operand(node.left, static)
                    or NoHostSyncInJit._traced_operand(node.right, static))
        return True


_WALLCLOCK_CALLS = ("time.time", "time.monotonic", "time.perf_counter",
                    "datetime.datetime.now", "datetime.now")
# AST-DT1 carve-out: serve/telemetry.py owns the ONE sanctioned
# wall-clock source on serve paths (its ``monotonic()`` is the default
# behind every injectable clock).  Everything else under the determinism
# scope must inject a clock; a direct wall-clock call there still fires.
_DT1_EXEMPT = ("repro_torch/serve/telemetry.py",)
_UNSEEDED_RNG = ("random.random", "random.randint", "random.choice",
                 "random.shuffle", "random.uniform", "np.random.rand",
                 "np.random.randn", "np.random.randint",
                 "numpy.random.rand", "numpy.random.randn")
# torch's global-RNG draws: unseeded unless a generator= is passed
_TORCH_RNG = ("torch.rand", "torch.randn", "torch.randint",
              "torch.randperm")


class ServeDeterminism(Rule):
    id = "AST-DT1"
    severity = Severity.ERROR
    invariant = ("deterministic serve/fault paths call no wall-clock and "
                 "no unseeded global RNG: scheduling must replay from the "
                 "seed alone (injected clocks / named Generators only; "
                 "serve/telemetry.py is the one sanctioned clock source)")
    origin = "PR 6"

    def check(self, ctx: Dict[str, Any]) -> Optional[List[Finding]]:
        files: Optional[List[_File]] = ctx.get("files")
        scope: Optional[str] = ctx.get("determinism_scope")
        if files is None or scope is None:
            return None
        out: List[Finding] = []
        for f in files:
            fpath = str(f.path).replace("\\", "/")
            if scope not in fpath:
                continue
            if any(ex in fpath for ex in _DT1_EXEMPT):
                continue
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call) or f.ok(node):
                    continue
                name = _dotted(node.func)
                if name in _WALLCLOCK_CALLS:
                    out.append(self.finding(
                        f"wall-clock call {name}() in deterministic "
                        f"serve path (inject a clock instead)",
                        subject=f.loc(node), call=name))
                elif name in _UNSEEDED_RNG or (
                        name in _TORCH_RNG and not any(
                            k.arg == "generator" for k in node.keywords)):
                    out.append(self.finding(
                        f"unseeded global RNG {name}() in deterministic "
                        f"serve path (use a seeded np.random.Generator or "
                        f"torch.Generator)",
                        subject=f.loc(node), call=name))
        return out


NO_IMPORT_DEVICE_WORK = register(NoImportTimeDeviceWork())
NO_JIT_SIDE_EFFECTS = register(NoJitSideEffects())
NO_HOST_SYNC_IN_JIT = register(NoHostSyncInJit())
SERVE_DETERMINISM = register(ServeDeterminism())

AST_RULES = [NO_IMPORT_DEVICE_WORK, NO_JIT_SIDE_EFFECTS,
             NO_HOST_SYNC_IN_JIT, SERVE_DETERMINISM]


def ast_context(paths: Iterable[Path],
                determinism_scope: str = "repro_torch/serve",
                step_bodies: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> Dict[str, Any]:
    """Build the ctx dict the AST rules consume from a set of paths
    (``step_bodies`` defaults to ``STEP_BODIES``)."""
    return {"files": _iter_files(paths, step_bodies),
            "determinism_scope": determinism_scope}
