"""Batched serving engine (port of ``repro.serve.engine``): slot-based
continuous batching over a fixed-size decode batch, with bucketed prefill
admission into free slots, self-speculative decoding, a paged KV cache and
the reference's control plane — the request lifecycle with preemption and
resume, numeric guards and fault injection, chunked prefill, the SLO
admission controller and telemetry.

Admission pads each prompt to its power-of-2 length bucket
(serve/bucketing.py) and prefills the prompts sharing a bucket in ONE
batched call, with the batch size itself rounded up to a power of 2
(capped at ``n_slots``).  The prefill reads logits at each prompt's true
last token, and the fragment enters the batched cache through a masked
insert: K/V positions past the true length are zeroed and the fill
counter is set to the true length, so bucketed and unbucketed admission
emit the same tokens.  ``step()`` decodes every slot in one batched
``decode_step`` and appends one token per active request; a request
retires at its budget, at EOS (also for the prefill-sampled first token)
or, TRUNCATED, when its slot cache is full.

CLAQ-quantized weights are compiled into ahead-of-time plans once at
construction (``prepare_tree``), so every quantized matmul runs the
dequant-GEMM kernel, one launch per distinct bit-width.
``act_dtype="int8"`` additionally opts every quantized matmul into
per-token dynamic int8 activations (``modules.activation_quant`` scopes
prefill and decode; the scales ride each matmul's last launch).

Request lifecycle (serve/lifecycle.py): every request carries an explicit
state machine (QUEUED -> [PREFILLING ->] RUNNING -> {FINISHED, TRUNCATED,
ABANDONED, FAILED, PREEMPTED}; PREEMPTED -> QUEUED) with an optional
deadline and priority.  ``submit()`` enqueues into a bounded admission
queue and raises typed ``AdmissionRejected`` backpressure when it is full;
each ``step()`` first runs ``pump()``: deadline-expired work is ABANDONED
(queued, prefilling or running — partial tokens are kept), cache pressure
is applied, the controller decides, and free slots are filled from the
queue (highest priority first, resumed work ahead of fresh).

Preemption (``on_pressure="preempt"``, the default): when the effective
slot-cache limit drops below a request's fill (``set_cache_pressure``, a
fault plan's pressure window), when the page pool runs dry at decode, or
when strictly-higher-priority work waits behind a full engine, the
lowest-priority/youngest victim is PREEMPTED — its slot cleared by
``_rollback_tail`` — and re-queued at the front.  Resume re-prefills the
ORIGINAL prompt at batch 1, then replays the generated prefix through
decode at batch 1, teacher-forced: the decode steps the uninterrupted run
executed, so on the CPU a resumed request's tokens are bitwise an
uninterrupted run's.  (Prefilling prompt + prefix would not be: prefill
reduces attention blockwise with an online softmax, decode directly.)
Truncation survives where resume is impossible (the fill reached
``max_len``), under ``on_pressure="truncate"``, and for int8 resident
pages and kv_int8 admissions, whose quantized history an fp replay cannot
reproduce.

Numeric guards (``guards=True``): one ``isfinite`` count per row of the
prefill, decode and verify logits, brought to the host in the SAME
transfer as the sampled tokens; a non-finite row quarantines ONLY its
request (FAILED, with phase, count and engine step) — mid speculation
window the slot is rolled back first.  ``faults=FaultInjector(...)``
(serve/faults.py) adds its per-slot NaN/Inf vector to the logits on the
device before the argmax and the guard (only at the steps its plan names:
elsewhere the vector is zeros and adding it changes no bit), drives
pressure windows, and raises planned transient ``EngineFault``s before
any state changes, so a bounded-retry caller simply calls ``step()``
again.  Engines without guards or faults run the same step as before.

Self-speculative decoding (``draft_params=`` — the same checkpoint
quantized at a lower bit-width from the same calibration, see
``launch.quantize.claq_quantize_with_draft`` — and ``spec=SpecConfig(γ)``):
``step()`` becomes a propose/verify/rollback window (serve/speculative.py):
γ+1 draft decodes, ONE target span verify (``models.api.decode_span``),
greedy acceptance, and a per-slot rollback of both caches
(``_rollback_tail``).  Retirement applies token by token in emission
order, so a request retires at the token vanilla decode would retire it
at.  The draft gets its own plans (``draft_plan_bn``/``draft_plan_bk``
cap its tiles) and its own cache, prefilled beside the target's.  The
window's drafts, greedy tokens and guard counts come to the host in one
transfer.

Paged KV cache (``kv_layout="paged"``): each layer owns a page pool
``(n_pages + 1, page_size, ...)`` (the last row is the scratch page) and
every slot a page-table row, mirrored on the host and copied to the device
before a step that reads it (``_sync_tables``).  Pages are allocated on
demand — at admission for the prompt (all or nothing: ``PoolExhausted``
leaves nothing admitted), before each step for the step's K/V writes
(``_ensure_capacity``) — zeroed when fresh, and freed at retirement and
preemption.  Prefill stays contiguous; fragments are scattered into pages
afterwards (``_paged_insert``).  Paged fp decode is bit-identical to
contiguous decode: the gathered view has the contiguous cache's shape.
``kv_dtype="int8"`` stores pages quantized per token row (scale/2 error
per element, about 1/4 of fp32's bytes).  Requests sharing a prompt
prefix share physical pages (``PrefixRegistry``, refcounted) and copy on
write at their first write into a shared page.  Under pool pressure at
decode, registry entries are evicted first, then victims are preempted;
the starved request retires TRUNCATED (``pool_exhausted`` diagnostics)
only when nothing preemptible is left.

Chunked prefill (``chunked_prefill=C`` or a ``ChunkedPrefillConfig``):
admission reserves slots (and pages) and the prompts prefill C tokens at a
time into a contiguous fragment, interleaved with decode steps under a
per-step token budget; the batched cache is written once, at completion.

Overload control (``controller=AdmissionController(...)``, attached last
in ``__init__``) walks a degradation ladder — ``spec_half`` (γ//2
windows), ``spec_off`` (vanilla decode that keeps the draft cache
filled), ``kv_int8`` (new admissions' K/V through int8-page numerics),
``shed`` — and sets the chunk budget; ``cost_model=StepCostModel()``
prices each step from the work it ran (``last_step_cost_ms``), which the
replayer advances a ``StepClock`` by.  ``telemetry=Telemetry()`` records
per-request spans at the reference's call sites; it only observes (no
tensor is read for it).

PyTorch runs eagerly, so there are no traces to count: ``prefill_traces``
is the number of distinct (batch, bucket) prefill shapes run, and the
other ``*_traces`` counters of ``stats()`` the distinct shapes of their
calls — the quantities the reference bounds by its trace counts.  A
``TraceSentinel`` (``analysis/trace_rules.py``) observes the signature of
every call at the reference's call sites, a record kept apart from those
counters, so the trace rules cross-check the two.

Contract gate (``verify_contracts=True``, run last in ``__init__``): the
hot-path contract checker (``repro_torch.analysis``) profiles one decode
step on a clone of the slot cache — and the same step of a dense twin
over the dequantized weights, when the engine holds plans — and runs the
step-artifact and trace rules over it; ERROR findings raise
``ContractViolation`` before the engine serves a token, and the report is
kept as ``contract_report``.  The engine's own state (caches, counters,
call shapes, clock, telemetry) is what it was before the gate.  A step's
transfers go through two counted helpers, ``to_host`` (the one
device-to-host copy of a step: ``_sample``'s tokens and guard counts) and
``to_device`` (tokens, a dirty page table, a fault vector), which the
gate's ``HLO-HT1`` holds the step to.

Families: dense and moe, with GQA or MLA attention, rwkv and the hybrid
(encdec is refused at construction, as in the reference).  moe, as in
the reference, admits unpadded and one request per prefill, cannot
preempt (pressure truncates) and refuses chunked prefill and
speculation.  rwkv, the hybrid and windowed configs admit unpadded
(prompts of one length share a prefill), preempt and resume, and refuse
chunked prefill, speculation and paging.  The cache helpers work by leaf
name (``_SEQ_LEAVES``, ``_POOL_SRC``), so GQA's k/v and MLA's latent
c_kv/k_pe ride the same insert, rollback and page scatter; the insert
copies every other leaf whole (the recurrent ``state``/``conv``/``ssm``
and token-shift rows), and the rollback leaves those alone.

Multi-rank serving (``mesh=``, a ``DeviceMesh`` over ("data", "model")
or ("pod", "data", "model"), one process per rank, every rank running
this engine on the same requests — SPMD): params are placed by
``dist.sharding.spec_for_param_serve`` (each quantized unit split along N in whole tiles
into a shard-local plan, dense leaves by their largest model-divisible
dim) and the slot caches by ``spec_for_cache`` (slots over "dp", which
is "data", or pod x data row-major; KV heads over "model"; a paged
pool's page rows over "dp" where "dp" divides them, its tables
replicated).  Each data rank decodes its own slots' rows, and the
sampled tokens (with the guard counts) are all-gathered over "dp" (over
"data", then "pod") before the step's one host transfer, so every rank's
scheduler sees every token.  A prefill whose batch "dp" divides runs a
data rank's block of its rows (``dctx.rows_over_dp``, as the reference's
constraints place a batch), its first tokens gathered like a step's and
its fragment all-gathered over "dp" before each rank inserts its own
slots' rows (or the pages it holds); other prefills (a batch of 1, the
resume replay, the moe family's) run every row on every data rank.

A pool split over "dp" (``sharding.pool_blocks``: a block of rows a
rank) keeps every host structure as it is — the allocator, the table
mirror, the registry, every decision, byte for byte the single
device's — and routes the device work by page owner: ``_sync_tables``
rebuilds the rank's ``PageRoute`` (``sharding.page_route``) with the
tables; a decode or verify write is gathered over "dp" and lands on the
page's owner; a view takes the pages its slots name from its block and
from one exchange of the pages another rank holds
(``collectives.exchange``, only those pages), scratch read as zeros;
the admission scatter, page zeroing and copy-on-write touch the pages
this rank holds (a copy between two ranks' pages crosses in one
exchange).  Every collective moves bytes, or is an all-gather or a sum
with one non-zero term, so on the CPU a sharded engine's tokens are
bitwise the single device's.  Wall-clock decisions (deadlines, the
controller) read rank 0's clock, broadcast (``_RankZeroClock``), so every
rank decides alike.
A decode step's rows are the data rank's slots (``dctx.rows_over_dp``:
the MoE routes the global batch from them over "dp", see
``models.moe``).  The recurrent families keep their state leaves (rwkv ``state``/``prev_tm``/
``prev_cm``, Mamba2 ``conv``/``ssm``) slot rows over "dp" with every
head and channel on every model rank, and the hybrid's ring caches split
their KV heads over "model" as dense caches do; the insert, a preempted
slot's clear and a resume's insert act on the data rank's own rows.
Every family the engine serves (not encdec, on a mesh or without one)
takes a mesh of any size (f32 or int8 activations, contiguous or paged,
whole or split over "dp", with or without speculation where the family
takes it).  ``stats()["mesh"]`` is the mesh's {dim name: size}.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.analysis import op_trace
from repro_torch.dist import collectives as coll
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.analysis.trace_rules import TraceSentinel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.plan import prepare_tree
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tf

from . import lifecycle as lc
from . import speculative
from .admission import AdmissionController, StepCostModel
from .bucketing import BucketingPolicy
from .chunked_prefill import ChunkedPrefillConfig, PrefillGroup
from .faults import FaultInjector, nonfinite_rows
from .lifecycle import (AdmissionQueue, AdmissionRejected, DeadlineExceeded,
                        EngineFault, IncompleteRun, RequestState, RetryPolicy,
                        TERMINAL_STATES)
from .paging import PageAllocator, PoolExhausted, PrefixRegistry
from .speculative import SpecConfig
from .telemetry import MetricsRegistry, Telemetry, registry_from_stats

# Families whose caches are position-indexed and masked by a fill counter,
# making right-padding invisible to valid tokens (the reference's gate for
# bucketing and chunked prefill, with no attention window: a ring cache
# keeps the padded suffix's keys).  moe is excluded although its cache is
# attention-shaped: capacity-bounded routing sees the padded suffix (cap
# and the group-local cumsum depend on the token count), and its prefill
# rows are batch-dependent, so moe admits unpadded, one request a prefill.
_PADDED_FAMILIES = ("dense",)

# Cache leaf names with a sequence axis to zero-mask past the true length
# (KVCache.k/v, MLACache.c_kv/k_pe), and the paged pools and their int8
# scales, each mapped to the contiguous-fragment leaf that feeds it at
# admission (PagedKVCache kp/vp, PagedMLACache cp/pp).  The table is
# the engine's (see _sync_tables) and the fill counter hides a
# rolled-back tail in pages, as in the contiguous layout.
_SEQ_LEAVES = ("k", "v", "c_kv", "k_pe")
_POOL_SRC = {"kp": "k", "vp": "v", "cp": "c_kv", "pp": "k_pe"}
_SCALE_OF = {"kp": "k_scale", "vp": "v_scale", "cp": "c_scale",
             "pp": "p_scale"}


def _seq_leaves(c) -> List[str]:
    return [f for f in c._fields if f in _SEQ_LEAVES]


def _pool_leaves(c) -> List[str]:
    return [f for f in c._fields if f in _POOL_SRC]


def _keep(pos_len: int, lens: torch.Tensor, t: torch.Tensor):
    """(B, pos_len, 1, ...) mask of positions < lens, broadcast to ``t``'s
    rank."""
    keep = (torch.arange(pos_len, device=lens.device)[None, :]
            < lens[:, None])
    return keep.view(keep.shape + (1,) * (t.dim() - 2))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    state: RequestState = RequestState.QUEUED
    priority: int = 0                   # higher preempts lower under load
    deadline: Optional[float] = None    # absolute clock() time, or None
    submitted_at: float = 0.0
    preemptions: int = 0                # times this request was preempted
    diagnostics: Optional[Dict[str, Any]] = None
    kv_int8: bool = False               # admitted under the kv_int8 rung:
                                        # prefill K/V carries int8-page
                                        # numerics, so no fp resume replay
                                        # can reproduce it (non-preemptible)

    @property
    def tokens_out(self) -> int:
        """Tokens emitted so far (the TPOT denominator is one less)."""
        return len(self.tokens)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def truncated(self) -> bool:
        return self.state is RequestState.TRUNCATED

    def transition(self, new_state: RequestState) -> None:
        lc.transition(self, new_state)


def _masked_group_insert(full: List, frag: List, slots: Sequence[int],
                         lens: Sequence[int], masked: bool) -> List:
    """Copy the first ``len(slots)`` rows of a prefill fragment into the
    batched cache at ``slots`` (in place): every leaf row, so recurrent
    leaves (rwkv ``state``/``prev_tm``/``prev_cm``, Mamba2 ``conv``/
    ``ssm``) replace the slot's previous occupant's.  When ``masked``
    (padded admission) only each row's first ``lens[r]`` positions are
    kept: the padded tail of every sequence leaf is zeroed and the fill
    counter pinned to the true length, so the batched cache is what an
    unpadded prefill would have left."""
    B = len(slots)
    dev = full[0].length.device
    slots_t = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
    lens_t = torch.as_tensor(list(lens), dtype=torch.int32, device=dev)
    out = []
    for fl, fr in zip(full, frag):
        seq = _seq_leaves(fl)
        for f in fl._fields:
            if f == "length" or getattr(fl, f) is None:
                continue
            t = getattr(fr, f)[:B]
            if masked and f in seq:
                t = torch.where(_keep(t.shape[1], lens_t, t), t,
                                torch.zeros((), dtype=t.dtype, device=dev))
            getattr(fl, f)[slots_t] = t
        length = fl.length.clone()
        length[slots_t] = (lens_t if masked else fr.length[:B]).to(
            length.dtype)
        out.append(fl._replace(length=length))
    return out


def _rollback_tail(cache: List, new_lens) -> List:
    """Rewind every slot's fill counter to ``new_lens`` ((B,) ints) and,
    in a contiguous cache, zero the sequence positions at or past it, in
    place — the per-slot rollback a rejected speculation window needs,
    and (with a victim's length set to 0) the slot clear preemption needs.
    The rolled-back cache is bit-identical to one that never saw the tail
    (the tail past a slot's fill is zero from init and the masked insert).
    A paged cache rewinds by its fill counter alone: the tail's rows stay
    in their pages, hidden by the mask and overwritten by the next
    write.  Recurrent leaves are left alone, as in the reference: only
    preemption rolls back a recurrent family, and its slot is rewritten
    whole at the next admission."""
    dev = cache[0].length.device
    n = torch.as_tensor(np.asarray(new_lens), dtype=torch.int32, device=dev)
    out = []
    for c in cache:
        for f in _seq_leaves(c):
            t = getattr(c, f)
            t.masked_fill_(~_keep(t.shape[1], n, t), 0)
        out.append(c._replace(length=n))
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array: the step's one device-to-host transfer (the
    sampled tokens, with the guard counts), in a counted op-trace scope."""
    with op_trace.scope(op_trace.TO_HOST):
        return t.cpu().numpy()


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array uploaded as a step input (tokens, a fault vector), in
    a counted op-trace scope."""
    with op_trace.scope(op_trace.TO_DEVICE):
        return torch.as_tensor(a, device=device)


class _RankZeroClock:
    """A clock every rank of a mesh reads alike: rank 0's reading of
    ``clock``, broadcast over the world at every call (the ranks call it
    in the same order, as they run the same schedule)."""

    def __init__(self, clock, device):
        self.clock = clock
        self.device = device

    def __call__(self) -> float:
        import torch.distributed as dist
        t = torch.tensor([self.clock()], dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())


def _meshed(fn):
    """Run an engine method that calls the model under the engine's mesh
    (``dist.context.use_mesh``: the sharded layers read it)."""
    import functools

    @functools.wraps(fn)
    def wrapped(self, *args, **kw):
        with dctx.use_mesh(self.mesh):
            return fn(self, *args, **kw)
    return wrapped


def _take_rows(frag: List, rows: Sequence[int]) -> List:
    """The fragment rows ``rows`` of a contiguous prefill fragment."""
    idx = torch.as_tensor(list(rows), dtype=torch.long,
                          device=frag[0].length.device)
    return [type(c)(*(t[idx] for t in c)) for c in frag]


class ServingEngine:
    def __init__(self, params, cfg, n_slots: int = 8, max_len: int = 1024,
                 dtype=torch.float32, prepare: bool = True,
                 min_bucket: int = 16, bucketing: bool = True,
                 plan_bn: Optional[int] = None,
                 plan_bk: Optional[int] = None,
                 draft_params=None, spec: Optional[SpecConfig] = None,
                 draft_plan_bn: Optional[int] = None,
                 draft_plan_bk: Optional[int] = None,
                 act_dtype: Optional[str] = None,
                 guards: bool = False,
                 faults: Optional[FaultInjector] = None,
                 queue_depth: Optional[int] = None,
                 on_pressure: str = "preempt",
                 clock=None,
                 kv_layout: str = "contiguous",
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 share_prefixes: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 chunked_prefill=None,
                 controller: Optional[AdmissionController] = None,
                 cost_model: Optional[StepCostModel] = None,
                 verify_contracts: bool = False,
                 mesh=None,
                 device="cuda"):
        """``params``: a ``Transformer`` (``models.api.init_params`` or
        ``convert.from_numpy_tree``) on ``device``.  ``dtype`` is the KV
        cache's (of the prefill fragments, and of fp pages).  ``prepare``
        compiles quantized kernels into plans (in place); ``plan_bn`` /
        ``plan_bk`` cap the plan's block sizes.  ``act_dtype``: None/"f32",
        or "int8" (needs ``prepare``).  ``draft_params`` + ``spec``:
        self-speculative decoding.  ``guards``/``faults``: numeric guards
        and a seeded fault plan.  ``queue_depth`` bounds the admission
        queue (default 2 * n_slots); ``on_pressure`` is "preempt" or
        "truncate"; ``clock`` is the engine's monotonic clock (default
        ``time.monotonic``; ``lifecycle.StepClock`` for replayable runs).
        ``kv_layout="paged"`` with ``page_size`` (default 16; divides
        ``max_len``), ``kv_pages`` (default: contiguous capacity),
        ``kv_dtype`` (None/"f32" or "int8") and ``share_prefixes``: the
        paged KV cache.  ``telemetry``, ``chunked_prefill``, ``controller``,
        ``cost_model``, ``verify_contracts`` and ``mesh``: see the module
        docstring."""
        if cfg.family == "encdec":
            raise NotImplementedError(
                "ServingEngine serves decoder-only families; encdec "
                "admission needs a frames input and a length-masked encoder")
        act_dtype = kops.normalize_act_dtype(act_dtype)
        if act_dtype is not None and not prepare:
            raise ValueError(
                "act_dtype='int8' needs ahead-of-time plans — drop "
                "prepare=False (the int8 path runs on prepared leaves only)")
        if on_pressure not in ("preempt", "truncate"):
            raise ValueError(
                f"on_pressure must be 'preempt' or 'truncate', got "
                f"{on_pressure!r}")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got "
                f"{kv_layout!r}")
        self._paged = kv_layout == "paged"
        if not self._paged and (page_size is not None or kv_pages is not None
                                or kv_dtype is not None):
            raise ValueError(
                "page_size / kv_pages / kv_dtype configure the paged cache "
                "— pass kv_layout='paged'")
        self.page_size = None
        self.n_pages = None
        self.kv_dtype = None
        if self._paged:
            api.validate_paged_support(cfg)
            if kv_dtype in (None, "f32"):
                kv_dtype = None
            elif kv_dtype != "int8":
                raise ValueError(
                    f"unsupported kv_dtype {kv_dtype!r} (expected 'f32' or "
                    f"'int8')")
            self.page_size = int(page_size) if page_size is not None else 16
            if self.page_size < 1 or max_len % self.page_size:
                raise ValueError(
                    f"page_size={self.page_size} must be >= 1 and divide "
                    f"max_len={max_len}")
            # capacity-equivalent default: the pool holds exactly what the
            # contiguous layout reserved; pass kv_pages to over/undercommit
            self.n_pages = (int(kv_pages) if kv_pages is not None
                            else n_slots * (max_len // self.page_size))
            self.kv_dtype = kv_dtype
        if draft_plan_bn is not None or draft_plan_bk is not None:
            if spec is None:
                raise ValueError(
                    "draft_plan_bn/draft_plan_bk tune the speculative "
                    "draft's plan tiles — pass spec=SpecConfig(...) and "
                    "draft_params")
            if not prepare:
                raise ValueError(
                    "draft_plan_bn/draft_plan_bk shape the draft's "
                    "ahead-of-time plans — they do nothing with "
                    "prepare=False, so that combination is rejected")
        if spec is not None:
            speculative.validate_spec_support(cfg)
            if draft_params is None:
                raise ValueError(
                    "speculative decoding needs draft_params (the same "
                    "checkpoint quantized at SpecConfig.draft_bits — see "
                    "launch.quantize.claq_quantize_with_draft)")
        elif draft_params is not None:
            raise ValueError("draft_params given without spec=SpecConfig(...)")
        # ---- chunked prefill (serve/chunked_prefill.py) ------------------
        # Chunks ride the model's uniform-fill prefill branch, which only
        # the linear-cache padded families have; the gate is hard.
        self.chunked: Optional[ChunkedPrefillConfig] = None
        if chunked_prefill is not None:
            cpc = (chunked_prefill
                   if isinstance(chunked_prefill, ChunkedPrefillConfig)
                   else ChunkedPrefillConfig(chunk_tokens=int(chunked_prefill)))
            if (cfg.family not in _PADDED_FAMILIES
                    or cfg.attn_window is not None):
                raise NotImplementedError(
                    f"chunked prefill supports the padded linear-cache "
                    f"families {_PADDED_FAMILIES} (family={cfg.family!r}, "
                    f"attn_window={cfg.attn_window!r})")
            if max_len % cpc.chunk_tokens:
                raise ValueError(
                    f"chunk_tokens={cpc.chunk_tokens} must divide max_len="
                    f"{max_len}: the final chunk would run past the cache "
                    f"end")
            self.chunked = cpc
        tf.validate_family(cfg)
        self.device = dev_lib.resolve(device)
        self.mesh = mesh
        self._ranks = 1
        if mesh is not None:
            self._ranks = self._check_mesh(mesh, cfg)
        prep_kw = {}
        if plan_bn is not None:
            prep_kw["bn"] = plan_bn
        if plan_bk is not None:
            prep_kw["bk"] = plan_bk
        self.params = prepare_tree(params, **prep_kw) if prepare else params
        self.cfg = cfg
        if self._ranks > 1:
            with dctx.use_mesh(mesh):
                shd.place_model(self.params, cfg, mesh)
        self.act_dtype = act_dtype
        self.n_slots = n_slots
        self.max_len = max_len
        # ---- lifecycle / robustness knobs --------------------------------
        self.guards = bool(guards)
        self.faults = faults
        self.on_pressure = on_pressure
        self._clock = clock if clock is not None else time.monotonic
        if self._ranks > 1:
            self._clock = _RankZeroClock(self._clock, self._collective_dev())
        # Per-request span recorder (serve/telemetry.py): every hook call
        # is guarded by ``is not None``, and it binds THIS engine's clock,
        # so StepClock runs record deterministic timestamps.
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach(n_slots=n_slots, clock=self._clock)
        self._pressure_limit: Optional[int] = None
        # moe decode rows are router-coupled: a batch-1 resume replay is
        # not bitwise the batched decode, so moe cannot preempt.  int8
        # resident pages cannot either: resume replays history through fp
        # decode, which cannot reproduce the quantized K/V the
        # uninterrupted run accumulated.  Pressure truncates instead.
        self._preemptible = (cfg.family != "moe"
                             and self.kv_dtype != "int8")
        self.queue = AdmissionQueue(
            queue_depth if queue_depth is not None else max(2 * n_slots, 1))
        # padding needs a family whose rows ignore a padded suffix
        self.bucketing = BucketingPolicy(
            min_bucket=min_bucket, max_len=max_len,
            enabled=(bucketing and cfg.family in _PADDED_FAMILIES
                     and cfg.attn_window is None))
        self._prefill_groups: List[PrefillGroup] = []
        self.chunks_processed = 0
        # ---- overload control plane (serve/admission.py) -----------------
        self.controller = controller
        self.cost_model = cost_model
        self.last_step_cost_ms: Optional[float] = None
        self._step_prefill_tokens = 0
        self._step_decode_calls = 0
        self._step_draft_calls = 0
        self._step_verify_tokens = 0
        # degradation-ladder knobs the controller drives; nominal values
        # make an uncontrolled engine behave exactly as before
        self._gamma_eff = spec.gamma if spec is not None else 0
        self._spec_enabled = spec is not None
        self._kv_int8_admission = False
        # distinct speculative window sizes this engine may verify at
        # (controller.attach adds γ//2 when the spec_half rung exists)
        self.verify_gammas = {spec.gamma} if spec is not None else set()
        self._cache_dtype = dtype
        self._cache_kw: Dict[str, Any] = {}
        if self._paged:
            self._cache_kw = dict(page_size=self.page_size,
                                  n_pages=self.n_pages,
                                  kv_dtype=self.kv_dtype)
        self._rows: Optional[slice] = None
        self._blocks: Optional[shd.PoolBlocks] = None
        self.fragment_bytes_in = 0
        self.cache = self._make_slot_cache()

        self.spec = spec
        self.draft_params = None
        self.draft_cache = None
        if spec is not None:
            dprep_kw = dict(prep_kw)
            if draft_plan_bn is not None:
                dprep_kw["bn"] = draft_plan_bn
            if draft_plan_bk is not None:
                dprep_kw["bk"] = draft_plan_bk
            self.draft_params = (prepare_tree(draft_params, **dprep_kw)
                                 if prepare else draft_params)
            if self._ranks > 1:
                with dctx.use_mesh(mesh):
                    shd.place_model(self.draft_params, cfg, mesh)
            self.draft_cache = self._make_slot_cache()

        # ---- paged-cache host state: allocator, tables, counters ---------
        self.allocator: Optional[PageAllocator] = None
        self.prefix_registry: Optional[PrefixRegistry] = None
        if self._paged:
            self.allocator = PageAllocator(self.n_pages, self.page_size)
            if share_prefixes:
                self.prefix_registry = PrefixRegistry(self.allocator)
            # host mirror of every slot's table row; the engine is the sole
            # mutator — _sync_tables copies it into the device tables
            # before a step reads them
            self._tables = np.full((n_slots, max_len // self.page_size),
                                   self.allocator.scratch, np.int32)
            self._tables_dirty = False
            self._route = None
            if self._blocks is not None:
                self._route = shd.page_route(self._tables, self._blocks,
                                             self._rows is not None,
                                             self.device)
            self._req_pages: Dict[int, List[int]] = {}
            self.cow_copies = 0
            self.prefix_hits = 0
            self.prefix_shared_tokens = 0
            self.page_evictions = 0
            self.peak_pages_in_use = 0
            self.peak_pages_per_request = 0

        self.free = list(range(n_slots))
        self.active: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.last_token = np.zeros((n_slots,), np.int64)
        self._uid = 0
        # distinct operand shapes per call kind ("decode", "draft_prefill",
        # "draft_decode", "verify", "chunk_prefill", "draft_chunk_prefill"):
        # the port's counterpart of the reference's per-jit trace counters
        self.call_shapes: Dict[str, set] = collections.defaultdict(set)
        # the signature of every call, observed at the reference's call
        # sites and kept apart from call_shapes: the trace rules
        # (repro_torch.analysis) cross-check the two and the budget
        self.sentinel = TraceSentinel()
        self.emitted_tokens = 0
        self.engine_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # lifecycle counters: terminal states, preemption/resume traffic,
        # and typed admission rejections (backpressure observed)
        self.state_counts: collections.Counter = collections.Counter()
        self.preemptions = 0
        self.resumes = 0
        self.admission_rejections = 0

        # The controller reads the engine's realized capabilities (spec,
        # kv_dtype) to build its ladder and may extend verify_gammas, so
        # it attaches before the contract gate, whose budgets read that set.
        if controller is not None:
            controller.attach(self)

        # Opt-in contract gate: profile one decode step (on a clone of the
        # slot cache) and run the step-artifact and trace rules over it,
        # raising ContractViolation before the engine serves a token.
        self.contract_report = None
        if verify_contracts:
            from repro_torch.analysis.artifacts import verify_engine
            self.contract_report = verify_engine(self)

    # ------------------------------------------------------------------ mesh
    @staticmethod
    def _check_mesh(mesh, cfg) -> int:
        """Validate ``mesh`` for ``cfg``; returns its number of ranks."""
        shape = dctx.mesh_shape(mesh)
        ranks = int(np.prod(list(shape.values()))) if shape else 1
        if ranks == 1:
            return 1
        if set(shape) - {"pod", "data", "model"}:
            raise NotImplementedError(
                f"mesh dims {tuple(shape)}: the engine serves on a (data, "
                f"model) or (pod, data, model) mesh")
        return ranks

    def _collective_dev(self) -> torch.device:
        """The device of a world-group collective's tensor: the card for
        nccl, the CPU for gloo (chosen by the backend, never by
        failure)."""
        import torch.distributed as dist
        return (self.device if dist.get_backend() == "nccl"
                else torch.device("cpu"))

    def _make_slot_cache(self) -> List:
        cache = api.make_cache(self.cfg, self.n_slots, self.max_len,
                               dtype=self._cache_dtype, device=self.device,
                               **self._cache_kw)
        if self._ranks == 1:
            return cache
        self._rows = self._row_block(self.n_slots)
        if self._paged:
            self._blocks = shd.pool_blocks(self.n_pages + 1, self.cfg,
                                           self.mesh)
        return shd.place_cache(cache, self.cfg, self.mesh)

    def _row_block(self, batch: int) -> Optional[slice]:
        """This data rank's block of ``batch`` rows where "dp" divides them
        (``spec_for_cache``'s batch rule), else None: every data rank
        runs every row, as the reference's ``constrain`` drops an axis
        that does not divide."""
        if self._ranks == 1:
            return None
        entry = shd.spec_for_cache(".length", (1, batch), self.cfg,
                                   shd.MeshAxes(self.mesh))[1]
        if entry is None:
            return None
        parts, index = shd.entry_block(entry, self.mesh,
                                       shd.mesh_coords(self.mesh))
        n = batch // parts
        return slice(index * n, (index + 1) * n)

    def _new_fragment(self, batch: int) -> List:
        """A contiguous prefill fragment of ``batch`` rows: this data
        rank's block of them where "dp" divides ``batch`` (the prefill runs
        those rows), else every row; its KV heads split over "model"."""
        frag = api.make_cache(self.cfg, batch, self.max_len,
                              dtype=self._cache_dtype, device=self.device)
        if self._ranks == 1:
            return frag
        return shd.place_cache(frag, self.cfg, self.mesh,
                               slots=self._row_block(batch) is not None)

    def _whole_fragment(self, frag, batch: int):
        """``frag`` with every one of its ``batch`` rows: where the prefill
        split them over "dp", each leaf's row blocks all-gathered (the
        bytes this rank received are counted in ``fragment_bytes_in``)."""
        if frag is None or self._row_block(batch) is None:
            return frag
        out = []
        for c in frag:
            leaves = [None if t is None else coll.gather_dp(t, self.mesh)
                      for t in c]
            self.fragment_bytes_in += sum(
                (t.numel() - u.numel()) * t.element_size()
                for t, u in zip(leaves, c) if t is not None)
            out.append(type(c)(*leaves))
        return out

    def _local(self, t):
        """This data rank's slot rows of a (n_slots, ...) step input."""
        return t if self._rows is None else t[self._rows]

    def _slot_view(self, cache: List) -> List:
        """The slot cache as the model reads it: a paged cache's table
        (replicated) cut to this data rank's slot rows, or, where the pool
        splits over "dp", the rank's ``PageRoute`` in its place."""
        if not self._paged:
            return cache
        if self._blocks is not None:
            return [c._replace(table=self._route) for c in cache]
        if self._rows is None:
            return cache
        return [c._replace(table=c.table[self._rows]) for c in cache]

    def _slot_unview(self, cache: List, like: List) -> List:
        if not self._paged or (self._rows is None and self._blocks is None):
            return cache
        return [c._replace(table=t.table) for c, t in zip(cache, like)]

    def _local_slots(self, slots: Sequence[int]):
        """(fragment rows, local slot indices) of the ``slots`` this data
        rank holds."""
        if self._rows is None:
            return list(range(len(slots))), list(slots)
        lo, hi = self._rows.start, self._rows.stop
        rows = [i for i, s in enumerate(slots) if lo <= s < hi]
        return rows, [slots[i] - lo for i in rows]

    def _rollback(self, cache: List, lens) -> List:
        """``_rollback_tail`` of a slot cache, ``lens`` per global slot."""
        return _rollback_tail(cache, self._local(np.asarray(lens)))

    @property
    def clock(self):
        """The engine's injectable monotonic clock (``StepClock`` in
        deterministic runs) — callers and the replayer read time through
        this, never through the wall clock directly."""
        return self._clock

    @property
    def prefill_traces(self) -> int:
        """Distinct (batch, bucket) prefill shapes run so far."""
        return len(self.bucketing.stats.per_shape)

    def _caches(self) -> List[List]:
        """The slot caches: the target's, and the draft's under speculation."""
        return [self.cache] + ([self.draft_cache]
                               if self.spec is not None else [])

    # ------------------------------------------------------------- paged sync
    def _sync_tables(self) -> None:
        """Copy the host page-table mirror into every cache's device table
        (one tensor shared by a cache's layers) before a step reads it;
        clean steps cost nothing."""
        if not self._paged or not self._tables_dirty:
            return
        host = torch.from_numpy(self._tables)
        for cache in self._caches():
            for table in {id(c.table): c.table for c in cache}.values():
                with op_trace.scope(op_trace.TO_DEVICE):
                    table.copy_(host)
        if self._blocks is not None:
            # the split pool's exchange lists, from the same mirror
            with op_trace.scope(op_trace.TO_DEVICE):
                self._route = shd.page_route(self._tables, self._blocks,
                                             self._rows is not None,
                                             self.device)
        self._tables_dirty = False

    def _pool_tensors(self) -> List[torch.Tensor]:
        """Every pool and scale tensor of the target (and draft) cache, in
        one fixed order: the plumbing of page zeroing and COW."""
        return [t for cache in self._caches() for c in cache
                for f in _pool_leaves(c)
                for t in (getattr(c, f), getattr(c, _SCALE_OF[f]))
                if t is not None]

    def _own(self, pages: Sequence[int]) -> List[int]:
        """The rows of ``pages`` (global ids) in this rank's pool: every
        page of a whole pool; of a pool split over "dp", the pages this
        rank's block holds."""
        if self._blocks is None:
            return [int(p) for p in pages]
        return [row for rank, row in map(self._blocks.owner, pages)
                if rank == self._blocks.index]

    def _ids(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long,
                               device=self.device)

    def _zero_pages(self, pages: Sequence[int]) -> None:
        """Zero freshly allocated pages in both caches (those this rank
        holds): every unwritten cache row stays exactly zero, so a
        recycled page never leaks its previous holder's rows, and masked
        rows add exactly 0.0."""
        idx = self._ids(self._own(sorted(set(int(p) for p in pages))))
        if idx.numel():
            for t in self._pool_tensors():
                t[idx] = 0

    def _copy_pages(self, pairs: Sequence) -> None:
        """Copy-on-write: duplicate the pool (and scale) rows of shared
        pages into fresh private ones, target and draft cache alike.  On a
        pool split over "dp" a pair whose pages two ranks hold crosses in
        one exchange of every pool's bytes (every rank knows every pair:
        the allocator is host state, the same on every rank)."""
        pairs = [(int(o), int(n)) for o, n in pairs]
        if self._blocks is None:
            olds, news = self._ids([o for o, _ in pairs]), \
                self._ids([n for _, n in pairs])
            for t in self._pool_tensors():
                t[news] = t[olds]
            return
        own = self._blocks.owner
        me, D = self._blocks.index, self._blocks.parts
        here = [(own(o)[1], own(n)[1]) for o, n in pairs
                if own(o)[0] == me == own(n)[0]]
        cross = [(own(o), own(n)) for o, n in pairs
                 if own(o)[0] != own(n)[0]]
        tensors = self._pool_tensors()
        if here:
            olds, news = self._ids([o for o, _ in here]), \
                self._ids([n for _, n in here])
            for t in tensors:
                t[news] = t[olds]
        if not cross:
            return
        counts = [[0] * D for _ in range(D)]
        for (s, _), (d, _) in cross:
            counts[s][d] += 1
        send = self._ids([o for d in range(D)
                          for (s, o), (dd, _) in cross if s == me and dd == d])
        news = self._ids([n for s in range(D)
                          for (ss, _), (d, n) in cross if ss == s and d == me])
        for t, got in zip(tensors, L.exchange_rows(tensors, send, counts,
                                                   self.mesh)):
            t[news] = got

    # ------------------------------------------------------------- page plans
    def _note_page_peaks(self, req: Optional[Request] = None) -> None:
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.allocator.pages_in_use)
        if req is not None:
            self.peak_pages_per_request = max(
                self.peak_pages_per_request,
                len(self._req_pages.get(req.uid, ())))

    def _alloc_evicting(self, n: int) -> List[int]:
        """Allocate n pages, evicting prefix-registry entries (oldest
        first) under exhaustion; ``PoolExhausted`` propagates only once
        even an empty registry cannot satisfy the request."""
        while True:
            try:
                return self.allocator.alloc(n)
            except PoolExhausted:
                if (self.prefix_registry is None
                        or not self.prefix_registry.evict_one()):
                    raise
                self.page_evictions += 1

    def _plan_pages(self, req: Request, n_tokens: int,
                    exact_ok: bool = True):
        """Reserve the pages covering ``n_tokens`` resident positions for
        one request: shared prefix pages first (retained read-only from
        the registry), fresh private pages for the rest.  Returns
        ``(pages, table_row, write_row)`` — ``write_row`` marks the blocks
        the admission scatter may write (scratch everywhere else: shared
        pages stay read-only until COW).  All-or-nothing: on
        ``PoolExhausted`` no reference survives.  ``exact_ok=False``
        (resume) shares only whole pages, since the resumed request's
        tokens diverge inside the first partial page."""
        ps, scratch = self.page_size, self.allocator.scratch
        mp = self.max_len // ps
        nb = -(-n_tokens // ps)
        shared: List[int] = []
        if self.prefix_registry is not None:
            _, shared = self.prefix_registry.lookup(req.prompt,
                                                    exact_ok=exact_ok)
            shared = shared[:nb]
        if shared:
            # retain BEFORE allocating: allocation may evict the donor's
            # registry entry, and only our reference keeps its pages alive
            self.allocator.retain(shared)
        try:
            priv = self._alloc_evicting(nb - len(shared))
        except PoolExhausted:
            if shared:
                self.allocator.free(shared)
            raise
        if shared:
            self.prefix_hits += 1
            self.prefix_shared_tokens += min(len(shared) * ps, n_tokens)
        pages = shared + priv
        row = np.full((mp,), scratch, np.int32)
        row[:nb] = pages
        wrow = np.full((mp,), scratch, np.int32)
        wrow[len(shared):nb] = priv
        return pages, row, wrow

    def _release_pages(self, req: Request) -> None:
        """Drop a retiring/preempted request's page references and point
        its table row back at scratch.  The stale device rows stay until
        the pages are reallocated (and zeroed) — the mask already hides
        them."""
        if not self._paged:
            return
        pages = self._req_pages.pop(req.uid, None)
        if pages:
            self.allocator.free(pages)
        if req.slot >= 0:
            self._tables[req.slot, :] = self.allocator.scratch
            self._tables_dirty = True

    def _paged_insert(self, cache: List, frag: List, slots: Sequence[int],
                      lens: Sequence[int], wrows) -> List:
        """Scatter a prefilled CONTIGUOUS fragment into pool pages — the
        paged counterpart of ``_masked_group_insert``.  ``wrows`` ((B,
        max_pages)) names the page each max_len block of each fragment row
        lands in; scratch marks blocks that are not this group's to write
        (shared prefix pages, the unallocated tail).  Rows past each true
        length are zeroed first; int8 pools quantize each token row on the
        way in.  The host table mirror is the caller's to update."""
        B = len(slots)
        ps = self.page_size
        mp = self.max_len // ps
        dev = self.device
        lens_t = torch.as_tensor(list(lens), dtype=torch.int32, device=dev)
        wflat = np.asarray(wrows).reshape(-1)
        sel = None
        if self._blocks is None:
            # a whole pool: every row's pages are written
            wt = self._ids(wflat)
        else:
            # a split pool: the pages this rank holds (scratch is not
            # written: it reads as zeros)
            scratch = self.allocator.scratch
            mine = [i for i, p in enumerate(wflat) if p != scratch
                    and self._blocks.owner(p)[0] == self._blocks.index]
            sel, wt = self._ids(mine), self._ids(self._own(wflat[mine]))
        # the fill counters are this rank's slots'
        rows, local = self._local_slots(slots)
        slots_t = torch.as_tensor(local, dtype=torch.long, device=dev)
        rows_t = torch.as_tensor(rows, dtype=torch.long, device=dev)
        out = []
        for pl, fr in zip(cache, frag):
            for f in _pool_leaves(pl):
                pool, scale = getattr(pl, f), getattr(pl, _SCALE_OF[f])
                src = getattr(fr, _POOL_SRC[f])[:B]
                v = torch.where(_keep(self.max_len, lens_t, src), src,
                                torch.zeros((), dtype=src.dtype, device=dev))
                v = v.reshape((B * mp, ps) + v.shape[2:])
                if sel is not None:
                    v = v[sel]
                if scale is None:
                    pool[wt] = v.to(pool.dtype)
                else:
                    xq, sc = kops.quantize_activations(v.flatten(2).float())
                    pool[wt] = xq.reshape(v.shape)
                    scale[wt] = sc[..., 0]
            length = pl.length.clone()
            length[slots_t] = lens_t[rows_t]
            out.append(pl._replace(length=length))
        return out

    def _insert(self, frag: List, dfrag, slots: Sequence[int],
                lens: Sequence[int], wrows, masked: bool) -> None:
        """Write prefill fragment rows (and the draft's) into the slot
        caches: the masked insert, or the paged scatter with ``wrows``."""
        if self._paged:
            self.cache = self._paged_insert(self.cache, frag, slots, lens,
                                            wrows)
            if dfrag is not None:
                self.draft_cache = self._paged_insert(
                    self.draft_cache, dfrag, slots, lens, wrows)
        else:
            rows, local = self._local_slots(slots)
            if not rows:
                return
            if rows != list(range(len(rows))):
                frag = _take_rows(frag, rows)
                dfrag = None if dfrag is None else _take_rows(dfrag, rows)
            lens = [lens[i] for i in rows]
            self.cache = _masked_group_insert(self.cache, frag, local, lens,
                                              masked)
            if dfrag is not None:
                self.draft_cache = _masked_group_insert(
                    self.draft_cache, dfrag, local, lens, masked)

    def _bind_pages(self, reqs: Sequence[Request], slots: Sequence[int],
                    plans: Dict[int, Any]) -> None:
        """After a paged insert: point the slots' table rows at the
        requests' planned pages and register their prompts for sharing
        (never a fake-quantized prefix on an fp pool: a nominal sharer
        would read kv_int8 numerics)."""
        for req, slot in zip(reqs, slots):
            pages, row, _ = plans[req.uid]
            self._tables[slot] = row
            self._req_pages[req.uid] = list(pages)
            if (self.prefix_registry is not None
                    and not (req.kv_int8 and self.kv_dtype != "int8")):
                self.prefix_registry.register(req.prompt, pages)
            self._note_page_peaks(req)
        self._tables_dirty = True

    # ------------------------------------------------------------------ admit
    @staticmethod
    def _fill(req: Request) -> int:
        """Slot-cache positions in use: the prompt plus one K/V write per
        decode step so far (the pending last token's write belongs to the
        next step)."""
        return len(req.prompt) + len(req.tokens) - 1

    def _make_request(self, prompt: Sequence[int], max_new_tokens: int,
                      eos_id: Optional[int], priority: int,
                      deadline_ms: Optional[float]) -> Request:
        prompt = list(prompt)
        if len(prompt) == 0:
            raise AdmissionRejected("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise AdmissionRejected(
                f"request does not fit its slot cache: {len(prompt)} "
                f"prompt + {max_new_tokens} new tokens > max_len="
                f"{self.max_len}; shorten the prompt, lower "
                f"max_new_tokens, or build the engine with a larger "
                f"max_len")
        now = self._clock()
        deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise DeadlineExceeded(
                    f"deadline_ms={deadline_ms} is already expired at "
                    f"submission")
            deadline = now + deadline_ms / 1e3
        req = Request(self._uid, prompt, max_new_tokens, eos_id,
                      priority=priority, deadline=deadline, submitted_at=now)
        self._uid += 1
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None, priority: int = 0,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue one request into the bounded admission queue (the
        backpressure path — ``AdmissionRejected`` when the queue is full
        or the request can never fit, ``DeadlineExceeded`` when its SLO
        is already blown).  Admission into a free slot happens at the
        next ``step()``/``pump()``; returns the uid."""
        try:
            req = self._make_request(prompt, max_new_tokens, eos_id,
                                     priority, deadline_ms)
            self.queue.push(req)
        except AdmissionRejected:
            self.admission_rejections += 1
            raise
        if self.telemetry is not None:
            self.telemetry.on_submit(req, self.engine_steps)
        return req.uid

    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                    eos_id: Optional[int] = None) -> int:
        return self.add_requests([prompt], max_new_tokens, eos_id)[0]

    def add_requests(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: int = 16,
                     eos_id: Optional[int] = None, priority: int = 0,
                     deadline_ms: Optional[float] = None) -> List[int]:
        """Admit prompts directly into free slots (bypassing the queue);
        those sharing a length bucket are prefilled in one batched call.
        Returns uids in prompt order (an immediate EOS or a one-token
        budget retires at admission — look in ``finished``).  Raises typed
        ``AdmissionRejected`` when the slots don't exist — use
        ``submit()`` for queued, backpressured admission.  A paged engine
        whose pool cannot hold every prompt raises ``PoolExhausted`` and
        admits none."""
        if len(prompts) > len(self.free):
            raise AdmissionRejected(
                f"need {len(prompts)} free slots, have {len(self.free)}")
        reqs = [self._make_request(p, max_new_tokens, eos_id, priority,
                                   deadline_ms) for p in prompts]
        if self.telemetry is not None:
            for req in reqs:
                self.telemetry.on_submit(req, self.engine_steps)
        self._admit(reqs)
        return [r.uid for r in reqs]

    @_meshed
    def _prefill(self, params, toks: np.ndarray, lens: np.ndarray):
        """Prefill a (Bb, bucket) token block into a fresh contiguous
        fragment; returns (logits at each row's last true token, frag).
        Where "dp" divides Bb, this data rank prefills its block of the
        rows (``_row_block``): the logits and the fragment are those
        rows'."""
        rows = self._row_block(toks.shape[0])
        frag = self._new_fragment(toks.shape[0])
        if rows is not None:
            toks, lens = toks[rows], lens[rows]
        with nn.activation_quant(self.act_dtype), \
                dctx.rows_over_dp(rows is not None):
            return api.prefill_step(
                params, self.cfg,
                {"tokens": torch.as_tensor(toks, device=self.device)},
                frag, logits_at=torch.as_tensor(lens - 1,
                                                device=self.device))

    def _sample(self, logits: torch.Tensor, split: bool = False):
        """Greedy tokens of ``logits`` (B, ..., V) and, with guards, the
        per-row non-finite counts — brought to the host in ONE transfer.
        ``split``: the logits are this data rank's block of the rows (its
        slots', or a split prefill's), whose results are all-gathered over
        "dp" first, in "dp" order.  Returns (tokens, counts or None) as
        numpy."""
        nxt = logits.argmax(dim=-1)
        if not self.guards:
            return to_host(coll.gather_dp(nxt, self.mesh) if split
                           else nxt), None
        nf = nonfinite_rows(logits).to(nxt.dtype)
        t = torch.cat([nxt.reshape(nxt.shape[0], -1), nf[:, None]], dim=1)
        host = to_host(coll.gather_dp(t, self.mesh) if split else t)
        return (host[:, :-1].reshape((host.shape[0],) + nxt.shape[1:]),
                host[:, -1])

    @torch.no_grad()
    def _admit(self, reqs: List[Request]) -> None:
        """Prefill-admit fresh requests into free slots, grouped by length
        bucket (one batched prefill per group; moe one per prefill).
        Chunked engines route to ``_admit_chunked``: slots are reserved
        now, prefill happens chunk by chunk across subsequent steps."""
        if self.chunked is not None:
            self._admit_chunked(reqs)
            return
        # moe prefill rows are coupled through router capacity (a row's
        # tokens change which of another row's tokens are dropped), so moe
        # admissions run one per prefill, as per-request admission would
        batch_safe = self.cfg.family != "moe"
        groups: Dict[Any, List[int]] = {}
        for i, req in enumerate(reqs):
            bucket = self.bucketing.bucket_for(len(req.prompt))
            groups.setdefault(bucket if batch_safe else (bucket, i),
                              []).append(i)
        # Paged: reserve every request's pages up front, so a late
        # PoolExhausted cannot leave half the batch admitted
        plans: Dict[int, Any] = {}
        if self._paged:
            try:
                for req in reqs:
                    plans[req.uid] = self._plan_pages(req, len(req.prompt))
            except PoolExhausted:
                for pages, _, _ in plans.values():
                    self.allocator.free(pages)
                raise
        tel = self.telemetry
        for key, idxs in groups.items():
            bucket = key if batch_safe else key[0]
            t0 = tel.now() if tel is not None else 0.0
            B = len(idxs)
            # batch size bucketed too (next power of 2, capped at n_slots);
            # dummy tail rows prefill padding that is never inserted
            Bb = min(1 << (B - 1).bit_length(), self.n_slots)
            toks = np.zeros((Bb, bucket), np.int64)
            lens = np.ones((Bb,), np.int64)
            for r, i in enumerate(idxs):
                toks[r, :len(reqs[i].prompt)] = reqs[i].prompt
                lens[r] = len(reqs[i].prompt)
            self.bucketing.record(Bb, bucket)
            self.sentinel.observe("prefill", (Bb, bucket))
            logits, frag = self._prefill(self.params, toks, lens)
            dfrag = None
            if self.spec is not None:
                # the draft needs the prompt in ITS cache too: its first
                # proposal continues from the target's first token
                self.call_shapes["draft_prefill"].add((Bb, bucket))
                self.sentinel.observe("draft_prefill", (Bb, bucket))
                _, dfrag = self._prefill(self.draft_params, toks, lens)
            self._step_prefill_tokens += Bb * bucket * (
                2 if self.spec is not None else 1)
            split = self._row_block(Bb) is not None
            frag = self._whole_fragment(frag, Bb)
            dfrag = self._whole_fragment(dfrag, Bb)
            if self._kv_int8_admission:
                # kv_int8 degradation rung: admit through int8 resident-page
                # numerics (the pool quantizes anyway when it is int8);
                # always mark the request so preemption skips it
                for i in idxs:
                    reqs[i].kv_int8 = True
                if self.kv_dtype != "int8":
                    frag = self._fake_quant_frag(frag)
                    if dfrag is not None:
                        dfrag = self._fake_quant_frag(dfrag)
            firsts, nf_h = self._sample(logits, split)
            slots = [self.free.pop(0) for _ in idxs]
            true_lens = lens[:B].tolist()
            wrows = (np.stack([plans[reqs[i].uid][2] for i in idxs])
                     if self._paged else None)
            self._insert(frag, dfrag, slots, true_lens, wrows,
                         self.bucketing.enabled)
            if self._paged:
                self._bind_pages([reqs[i] for i in idxs], slots, plans)
            if tel is not None:
                tel.on_admit([reqs[i].uid for i in idxs], slots, bucket,
                             Bb, tel.now() - t0, self.engine_steps)
            for r, i in enumerate(idxs):
                req = reqs[i]
                req.slot = slots[r]
                req.transition(RequestState.RUNNING)
                self.active[req.uid] = req
                if nf_h is not None and nf_h[r] > 0:
                    # non-finite prompt logits: quarantine at admission —
                    # no first token is sampled from garbage
                    self._quarantine(req, "prefill", int(nf_h[r]))
                else:
                    self._append_token(req, int(firsts[r]))

    # ------------------------------------------------------- chunked prefill
    def _admit_chunked(self, reqs: List[Request]) -> None:
        """Reserve slots and open a ``PrefillGroup``: the prompts prefill
        chunk by chunk across subsequent steps (``_process_chunks``) and
        the batched cache is only written at completion, so a
        mid-``PREFILLING`` preempt needs no rollback.  Paged pools reserve
        every page up front, all or nothing, as ``_admit`` does."""
        plans: Dict[int, Any] = {}
        if self._paged:
            try:
                for req in reqs:
                    plans[req.uid] = self._plan_pages(req, len(req.prompt))
            except PoolExhausted:
                for pages, _, _ in plans.values():
                    self.allocator.free(pages)
                raise
        tel = self.telemetry
        B = len(reqs)
        Bb = min(1 << (B - 1).bit_length(), self.n_slots)
        frag = self._new_fragment(Bb)
        draft_frag = None
        if self.spec is not None:
            draft_frag = self._new_fragment(Bb)
        slots = [self.free.pop(0) for _ in reqs]
        group = PrefillGroup(
            reqs=list(reqs), slots=slots,
            lens=[len(r.prompt) for r in reqs], bb=Bb, frag=frag,
            draft_frag=draft_frag, plans=plans,
            t0=tel.now() if tel is not None else 0.0)
        for req, slot in zip(reqs, slots):
            req.slot = slot
            req.transition(RequestState.PREFILLING)
            if self._paged:
                # pages live in _req_pages from reservation on, so the
                # one release path covers cancel mid-prefill and retire
                self._req_pages[req.uid] = list(plans[req.uid][0])
        self._prefill_groups.append(group)

    @property
    def pending_prefills(self) -> int:
        """Live requests currently mid-chunked-prefill."""
        return sum(len(g.live_rows()) for g in self._prefill_groups)

    @property
    def prefill_backlog_tokens(self) -> int:
        """Padded prefill tokens still owed to pending groups — the
        controller's defer signal."""
        if self.chunked is None:
            return 0
        C = self.chunked.chunk_tokens
        return sum(g.bb * C * g.chunks_remaining(C)
                   for g in self._prefill_groups)

    def _process_chunks(self) -> None:
        """Advance pending prefill groups by whole chunks, head group
        first, under the per-step padded-token budget (controller budget
        when attached, else the config's).  At least one chunk runs per
        step — progress is unconditional — and a group that finishes is
        completed immediately so its first tokens land this step."""
        if not self._prefill_groups:
            return
        C = self.chunked.chunk_tokens
        if self.controller is not None:
            budget = self.controller.prefill_budget()
        else:
            budget = self.chunked.budget_tokens
        spent = 0
        progressed = False
        while self._prefill_groups:
            g = self._prefill_groups[0]
            if not g.live_rows() or g.done:
                self._prefill_groups.pop(0)
                self._finish_group(g)
                continue
            cost = g.bb * C
            if budget is not None and progressed and spent + cost > budget:
                break
            self._run_chunk(g, C)
            spent += cost
            progressed = True
            if g.done:
                self._prefill_groups.pop(0)
                self._finish_group(g)

    @torch.no_grad()
    @_meshed
    def _run_chunk(self, g: PrefillGroup, C: int) -> None:
        """Run one ``(bb, C)`` chunk for a group: every live row advances
        C positions in the fragment cache.  Rows whose TRUE last prompt
        token falls inside this chunk stash their first-token argmax (and
        guard count) for completion; other rows' chunk logits are padding
        and are ignored, as monolithic prefill ignores all but the last
        position."""
        start = g.progress
        toks = np.zeros((g.bb, C), np.int64)
        for i in g.live_rows():
            seg = g.reqs[i].prompt[start:start + C]
            toks[i, :len(seg)] = seg
        lens = np.ones((g.bb,), np.int64)
        for i, n in enumerate(g.lens):
            lens[i] = n
        self.call_shapes["chunk_prefill"].add((g.bb, C))
        self.sentinel.observe("chunk_prefill", (g.bb, C))
        at = np.clip(lens - 1 - start, 0, C - 1)
        # this data rank's block of the group's rows where "dp" divides bb
        rows = self._row_block(g.bb)
        if rows is not None:
            toks, at = toks[rows], at[rows]
        toks_d = torch.as_tensor(toks, device=self.device)
        with nn.activation_quant(self.act_dtype), \
                dctx.rows_over_dp(rows is not None):
            logits, g.frag = api.prefill_step(
                self.params, self.cfg, {"tokens": toks_d}, g.frag,
                logits_at=torch.as_tensor(at, device=self.device))
            if self.spec is not None:
                self.call_shapes["draft_chunk_prefill"].add((g.bb, C))
                self.sentinel.observe("draft_chunk_prefill", (g.bb, C))
                _, g.draft_frag = api.prefill_step(
                    self.draft_params, self.cfg, {"tokens": toks_d},
                    g.draft_frag)
        g.progress = start + C
        self.chunks_processed += 1
        self._step_prefill_tokens += g.bb * C * (
            2 if self.spec is not None else 1)
        fin = [i for i in g.live_rows() if start <= g.lens[i] - 1 < start + C]
        if fin:
            firsts, nf_h = self._sample(logits, rows is not None)
            for i in fin:
                g.firsts[i] = int(firsts[i])
                if nf_h is not None:
                    g.nf[i] = int(nf_h[i])
        if self.telemetry is not None:
            live = g.live_rows()
            self.telemetry.on_chunk(
                [g.reqs[i].uid for i in live],
                [g.slots[i] for i in live], start, C, g.bb,
                self.engine_steps)

    @torch.no_grad()
    def _finish_group(self, g: PrefillGroup) -> None:
        """Complete a finished group: insert the fragment rows of every
        surviving member into the slot caches (the same masked insert /
        paged scatter as monolithic admission), transition them
        PREFILLING -> RUNNING, and release their stashed first tokens."""
        rows = g.live_rows()
        if not rows:
            return
        tel = self.telemetry
        reqs = [g.reqs[i] for i in rows]
        slots = [g.slots[i] for i in rows]
        lens = [g.lens[i] for i in rows]
        sel = _take_rows(self._whole_fragment(g.frag, g.bb), rows)
        dsel = (_take_rows(self._whole_fragment(g.draft_frag, g.bb), rows)
                if g.draft_frag is not None else None)
        if self._kv_int8_admission:
            for req in reqs:
                req.kv_int8 = True
            if self.kv_dtype != "int8":
                sel = self._fake_quant_frag(sel)
                if dsel is not None:
                    dsel = self._fake_quant_frag(dsel)
        wrows = (np.stack([g.plans[r.uid][2] for r in reqs])
                 if self._paged else None)
        # always masked: the fragment fill is chunk-padded past each row's
        # true length, so the tail must be zeroed on insert
        self._insert(sel, dsel, slots, lens, wrows, True)
        if self._paged:
            # real data lands in the pages only now: registering the
            # prefix any earlier would let a sharer read garbage
            self._bind_pages(reqs, slots, g.plans)
        if tel is not None:
            tel.on_admit([r.uid for r in reqs], slots, g.progress, g.bb,
                         tel.now() - g.t0, self.engine_steps)
        for req, i in zip(reqs, rows):
            req.transition(RequestState.RUNNING)
            self.active[req.uid] = req
            nfc = g.nf.get(i, 0)
            if nfc > 0:
                self._quarantine(req, "prefill", nfc)
            else:
                self._append_token(req, g.firsts[i])

    def _fake_quant_frag(self, frag: List) -> List:
        """Round-trip a fragment's sequence leaves through the int8
        resident-page numerics (per-token-row absmax/127, the quantizer the
        paged pool applies on write) — the kv_int8 rung's operating point
        for fp pools."""
        def fq(t):
            xq, sc = kops.quantize_activations(
                t.reshape(t.shape[0], t.shape[1], -1).float())
            return (xq.float() * sc).reshape(t.shape).to(t.dtype)
        return [c._replace(**{f: fq(getattr(c, f)) for f in _seq_leaves(c)})
                for c in frag]

    def _preempt_prefilling(self, req: Request, reason: str) -> None:
        """Preempt a mid-``PREFILLING`` request: drop its fragment
        progress and re-queue at the front.  No cache rollback — the slot
        row was never written — so only the reservation unwinds.  The
        caller cancels it from its group first."""
        if self.telemetry is not None:
            self.telemetry.on_preempt([(req.uid, req.slot)], reason,
                                      self.engine_steps)
        req.transition(RequestState.PREEMPTED)
        req.preemptions += 1
        self.preemptions += 1
        self._release_pages(req)
        self.free.append(req.slot)
        req.slot = -1
        req.transition(RequestState.QUEUED)
        self.queue.push_front(req)

    @torch.no_grad()
    @_meshed
    def _admit_resume(self, req: Request) -> None:
        """Resume a preempted request into a free slot: bucketed prefill
        of the ORIGINAL prompt at batch 1, then a teacher-forced decode
        replay of the generated prefix at batch 1 — the decode steps the
        uninterrupted run already executed — and one insert of the
        rebuilt fragment.  Replay runs fault-free (injection targets
        engine steps; catch-up re-executes history that ran cleanly)."""
        P, toks = req.prompt, req.tokens
        n = len(P)
        fill = n + len(toks) - 1
        tel = self.telemetry
        t0 = tel.now() if tel is not None else 0.0
        # Paged: reserve the resumed fill's pages BEFORE any replay work —
        # PoolExhausted must leave the request untouched (still QUEUED) so
        # _pump_queue can park it at the queue front.  Only whole prefix
        # pages are shared: the replayed decode writes land past them.
        plan = None
        if self._paged:
            plan = self._plan_pages(req, fill, exact_ok=False)
        bucket = self.bucketing.bucket_for(n)
        ta = np.zeros((1, bucket), np.int64)
        ta[0, :n] = P
        self.bucketing.record(1, bucket)
        self.sentinel.observe("prefill", (1, bucket))
        lens = np.array([n], np.int64)
        _, frag = self._prefill(self.params, ta, lens)
        if bucket != n:
            # the masked insert's padding fix: zero the padded K/V tail,
            # pin the fill counter to n
            frag = _rollback_tail(frag, lens)
        dfrag = None
        if self.spec is not None:
            self.call_shapes["draft_prefill"].add((1, bucket))
            self.sentinel.observe("draft_prefill", (1, bucket))
            _, dfrag = self._prefill(self.draft_params, ta, lens)
            if bucket != n:
                dfrag = _rollback_tail(dfrag, lens)
        with nn.activation_quant(self.act_dtype):
            for t in toks[:-1]:
                tok = torch.tensor([t], dtype=torch.long, device=self.device)
                self.call_shapes["decode"].add((1,))
                self.sentinel.observe("decode", (1,))
                _, frag = api.decode_step(self.params, self.cfg, tok, frag)
                self._step_decode_calls += 1
                if self.spec is not None:
                    self.call_shapes["draft_decode"].add((1,))
                    self.sentinel.observe("draft_decode", (1,))
                    _, dfrag = api.decode_step(self.draft_params, self.cfg,
                                               tok, dfrag)
                    self._step_draft_calls += 1
        self._step_prefill_tokens += bucket * (
            2 if self.spec is not None else 1)
        slot = self.free.pop(0)
        self._insert(frag, dfrag, [slot], [fill],
                     plan[2][None] if plan is not None else None, False)
        if self._paged:
            pages, row, _ = plan
            self._tables[slot] = row
            self._req_pages[req.uid] = list(pages)
            self._tables_dirty = True
            self._note_page_peaks(req)
        req.slot = slot
        req.transition(RequestState.RUNNING)
        self.active[req.uid] = req
        self.last_token[slot] = toks[-1]
        self.resumes += 1
        if tel is not None:
            tel.on_resume(req.uid, slot, max(len(toks) - 1, 0),
                          tel.now() - t0, self.engine_steps)

    # -------------------------------------------------------------- lifecycle
    def _retire(self, req: Request,
                state: RequestState = RequestState.FINISHED,
                diagnostics: Optional[Dict[str, Any]] = None) -> None:
        """Move a request (active or queued) to ``finished`` in a terminal
        state and recycle its slot — the one retirement bookkeeping for
        budget/EOS, truncation, abandonment, shedding and quarantine."""
        if diagnostics is not None:
            req.diagnostics = diagnostics
        if self.telemetry is not None:
            # before the slot recycle: the event carries the slot the
            # request retired from (-1 for queued work)
            self.telemetry.on_retire(req, state, self.engine_steps)
        req.transition(state)
        self._release_pages(req)
        if req.slot >= 0:
            self.free.append(req.slot)
            req.slot = -1
        self.active.pop(req.uid, None)
        self.finished[req.uid] = req
        self.state_counts[state.value] += 1

    def _quarantine(self, req: Request, phase: str, count: int) -> None:
        """Numeric-guard quarantine: FAIL only the offending request, with
        diagnostics, while the rest of the batch proceeds."""
        self._retire(req, RequestState.FAILED, diagnostics={
            "kind": "nonfinite_logits", "phase": phase,
            "nonfinite": count, "engine_step": self.engine_steps})

    def _append_token(self, req: Request, t: int) -> None:
        """Append a sampled token and apply retirement (budget / EOS) — the
        one place the check lives, prefill's first token included."""
        req.tokens.append(t)
        self.last_token[req.slot] = t
        if self.telemetry is not None:
            self.telemetry.on_token(req, self.engine_steps)
        if (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and t == req.eos_id)):
            self._retire(req, RequestState.FINISHED)

    def set_cache_pressure(self, limit: Optional[int]) -> None:
        """Force an effective slot-cache limit below ``max_len`` (None
        releases it).  Requests whose fill reaches the limit are preempted
        (or truncated under ``on_pressure="truncate"``) at the next step;
        the fault injector applies the same mechanism from its seeded
        pressure windows."""
        if limit is not None and limit < 2:
            raise ValueError(f"pressure limit must be >= 2, got {limit}")
        self._pressure_limit = limit

    def _effective_limit(self, step_idx: int) -> int:
        limit = self.max_len
        if self._pressure_limit is not None:
            limit = min(limit, self._pressure_limit)
        if self.faults is not None:
            fp = self.faults.pressure(step_idx, self.max_len)
            if fp is not None:
                limit = min(limit, fp)
        return limit

    def _victim_order(self) -> List[Request]:
        """Preemption order: lowest priority first, youngest (largest uid)
        within a priority — the cheapest work to redo."""
        return sorted(self.active.values(),
                      key=lambda r: (r.priority, -r.uid))

    def _preempt(self, victims: List[Request], reason: str) -> None:
        """Evict ``victims`` from their slots and re-queue them (front,
        bound-exempt) for a resume.  The slot caches are cleared with ONE
        rollback — victims' lengths pinned to 0 (K/V zeroed), surviving
        slots at their true fill (a no-op for them) — so a recycled slot
        is indistinguishable from a never-used one."""
        if self.telemetry is not None:
            self.telemetry.on_preempt([(r.uid, r.slot) for r in victims],
                                      reason, self.engine_steps)
        for req in victims:
            req.transition(RequestState.PREEMPTED)
            req.preemptions += 1
            self.preemptions += 1
            del self.active[req.uid]
            self._release_pages(req)
            self.free.append(req.slot)
            req.slot = -1
        lens = np.zeros((self.n_slots,), np.int32)
        for r in self.active.values():
            lens[r.slot] = self._fill(r)
        self.cache = self._rollback(self.cache, lens)
        if self.spec is not None:
            self.draft_cache = self._rollback(self.draft_cache, lens)
        for req in victims:
            req.transition(RequestState.QUEUED)
            self.queue.push_front(req)

    # ---------------------------------------------------------- decode pages
    def _alloc_decode_page(self, req: Request) -> int:
        """One fresh page for a running request's next K/V write: evict
        registry entries first, then preempt victims (policy permitting)
        until the pool yields a page; ``PoolExhausted`` propagates when
        nothing preemptible remains."""
        while True:
            try:
                page = self._alloc_evicting(1)[0]
                self._note_page_peaks()
                return page
            except PoolExhausted:
                # kv_int8 admissions are excluded: an fp prefix replay at
                # resume cannot reproduce their quantized cache history
                victims = [r for r in self._victim_order()
                           if r.uid != req.uid and not r.kv_int8]
                if (victims and self._preemptible
                        and self.on_pressure == "preempt"):
                    self._preempt(victims[:1], reason="pool_exhausted")
                    continue
                raise

    def _reserve_blocks(self, req: Request, horizon: int,
                        cow: List, fresh: List) -> None:
        """Make every table block the next ``horizon`` K/V writes of this
        request touch PRIVATE and allocated: scratch blocks get fresh
        pages (queued in ``fresh`` for zeroing), shared blocks (refcount >
        1) are replaced by private copies (queued in ``cow``) with the
        shared reference dropped — copy-on-write at the first write into
        shared territory.  Entries are uid-tagged: a preemption triggered
        by a later allocation may free and recycle pages queued earlier,
        and the caller filters stale entries by current ownership."""
        ps, scratch = self.page_size, self.allocator.scratch
        fill = self._fill(req)
        lo = fill // ps
        hi = min(fill + horizon - 1, self.max_len - 1) // ps
        s = req.slot
        pages = self._req_pages.setdefault(req.uid, [])
        for b in range(lo, hi + 1):
            pid = int(self._tables[s, b])
            if pid == scratch:
                new = self._alloc_decode_page(req)
                self._tables[s, b] = new
                pages.append(new)
                fresh.append((req.uid, new))
                self._tables_dirty = True
            elif self.allocator.refcount(pid) > 1:
                new = self._alloc_decode_page(req)
                self.allocator.free([pid])
                self._tables[s, b] = new
                pages[pages.index(pid)] = new
                cow.append((req.uid, pid, new))
                self.cow_copies += 1
                self._tables_dirty = True
        self._note_page_peaks(req)

    def _ensure_capacity(self, horizon: int) -> None:
        """Pre-step page reservation: every block the next ``horizon`` K/V
        writes touch must be private and allocated before the step runs
        (the model routes out-of-table writes to the scratch page).  Under
        exhaustion with nothing preemptible the starved request retires
        TRUNCATED with ``pool_exhausted`` diagnostics."""
        if not self._paged or not self.active:
            return
        cow: List = []
        fresh: List = []
        for uid in sorted(self.active):
            req = self.active.get(uid)
            if req is None:      # preempted by an earlier iteration's alloc
                continue
            try:
                self._reserve_blocks(req, horizon, cow, fresh)
            except PoolExhausted:
                self._retire(req, RequestState.TRUNCATED, diagnostics={
                    "kind": "pool_exhausted",
                    "pages_in_use": self.allocator.pages_in_use,
                    "n_pages": self.allocator.n_pages,
                    "engine_step": self.engine_steps})
        # a preemption or retirement mid-loop may have freed (and recycled)
        # queued pages; only zero/copy pages their planner still owns
        own = {u: set(p) for u, p in self._req_pages.items()}
        zs = [p for u, p in fresh if p in own.get(u, ())]
        pairs = [(o, n) for u, o, n in cow if n in own.get(u, ())]
        if zs:
            self._zero_pages(zs)
        if pairs:
            self._copy_pages(pairs)

    # --------------------------------------------------------------- pumping
    def _admissible(self, req: Request, limit: int) -> bool:
        """A queued request may take a slot only if its (prospective) fill
        sits below the effective cache limit — admitting it under pressure
        would just preempt it right back."""
        fill = len(req.prompt) + max(len(req.tokens), 1) - 1
        return fill < limit

    def pump(self) -> None:
        """Lifecycle housekeeping without decoding: abandon deadline-expired
        work (queued, prefilling and running — partial tokens are kept),
        apply cache pressure (preempt, or truncate under the opt-in
        policy), let the controller decide, then fill free slots from the
        queue — resumed work first, then fresh work, highest priority
        first; strictly-higher-priority queued work may preempt the
        lowest-priority/youngest running victim.  ``step()`` calls this
        first, so a caller that only calls ``step()`` still drives every
        request to a terminal state."""
        step_idx = self.engine_steps
        now = self._clock()
        for req in list(self.active.values()):
            if req.deadline is not None and now >= req.deadline:
                self._retire(req, RequestState.ABANDONED, diagnostics={
                    "kind": "deadline", "where": "running",
                    "engine_step": step_idx})
        for g in self._prefill_groups:
            for i in g.live_rows():
                req = g.reqs[i]
                if req.deadline is not None and now >= req.deadline:
                    g.cancel(req.uid)
                    self._retire(req, RequestState.ABANDONED, diagnostics={
                        "kind": "deadline", "where": "prefilling",
                        "engine_step": step_idx})
        limit = self._effective_limit(step_idx)
        # cache pressure reaches mid-PREFILLING work too: a prompt that no
        # longer fits under the limit is cancelled from its group
        # (preempt-to-queue when policy and numerics allow — free, since
        # the slot row was never written — else typed truncation)
        for g in self._prefill_groups:
            for i in g.live_rows():
                req = g.reqs[i]
                if len(req.prompt) >= limit:
                    g.cancel(req.uid)
                    if (self.on_pressure == "preempt" and self._preemptible
                            and not req.kv_int8):
                        self._preempt_prefilling(req, "cache_pressure")
                    else:
                        self._retire(req, RequestState.TRUNCATED,
                                     diagnostics={
                                         "kind": "cache_pressure",
                                         "limit": limit,
                                         "engine_step": step_idx})
        victims: List[Request] = []
        for req in self._victim_order():
            fill = self._fill(req)
            if fill >= self.max_len:
                # the slot cache is genuinely full before the budget: a
                # resume could not fit the replayed prefix either, so this
                # is terminal truncation whatever the policy
                self._retire(req, RequestState.TRUNCATED)
            elif fill >= limit:
                if (self.on_pressure == "preempt" and self._preemptible
                        and not req.kv_int8):
                    victims.append(req)
                else:
                    self._retire(req, RequestState.TRUNCATED, diagnostics={
                        "kind": "cache_pressure", "limit": limit,
                        "engine_step": step_idx})
        if victims:
            self._preempt(victims, reason="cache_pressure")
        if self.controller is not None:
            # the controller decides BEFORE admission: rung moves and
            # shedding apply to the queue this pump is about to drain
            self.controller.on_step(self)
        self._pump_queue(now, limit)

    def _pump_queue(self, now: float, limit: int) -> None:
        for req in self.queue.expire(now):
            self._retire(req, RequestState.ABANDONED, diagnostics={
                "kind": "deadline", "where": "queued",
                "engine_step": self.engine_steps})
        # strictly-higher-priority queued work evicts the lowest-priority/
        # youngest running request when no slot is free
        while (len(self.queue) and not self.free and self._preemptible
               and self.on_pressure == "preempt"):
            best = self.queue.peek_best(lambda r: self._admissible(r, limit))
            victims = [r for r in self._victim_order() if not r.kv_int8]
            if (best is None or not victims
                    or best.priority <= victims[0].priority):
                break
            self._preempt([victims[0]], reason="priority")
        # admit: resumed requests one by one (each replays its own prefix),
        # fresh requests collected and admitted in one bucketed batch.
        # Under controller deferral only resumed work passes (its slot
        # debt already exists; deferring it would strand generated tokens)
        allow_fresh = (self.controller.allow_fresh(self)
                       if self.controller is not None else True)
        fresh: List[Request] = []
        while len(self.free) - len(fresh) > 0:
            req = self.queue.pop_best(
                lambda r: self._admissible(r, limit)
                and (allow_fresh or r.tokens))
            if req is None:
                break
            if req.tokens:
                try:
                    self._admit_resume(req)
                except PoolExhausted:
                    # page-pool backpressure: the resume waits its turn at
                    # the queue front; pages drain as running work retires
                    self.queue.push_front(req)
                    break
            else:
                fresh.append(req)
        if fresh:
            try:
                self._admit(fresh)
            except PoolExhausted:
                for r in reversed(fresh):
                    self.queue.push_front(r)
        if self.controller is not None and not allow_fresh and self.free:
            blocked = sum(1 for r in self.queue.requests()
                          if not r.tokens and self._admissible(r, limit))
            if blocked:
                self.controller.note_defer(self, blocked)

    def _tick(self) -> None:
        """Per-step lifecycle prologue.  A planned transient fault raises
        BEFORE any state mutation, so a caller's retry of ``step()`` is
        idempotent."""
        if (self.faults is not None
                and self.faults.should_fail_step(self.engine_steps)):
            raise EngineFault(
                f"injected transient step failure at engine step "
                f"{self.engine_steps}", transient=True, diagnostics={
                    "kind": "transient_step_failure",
                    "engine_step": self.engine_steps})
        self.pump()

    def _inject_vec(self) -> Optional[torch.Tensor]:
        """The fault injector's additive per-slot logit vector for this
        step on the device, or None when no injector is wired or its plan
        names no fault here (the vector is then zeros, and adding zeros
        changes no logit)."""
        if self.faults is None:
            return None
        occupied = sorted(r.slot for r in self.active.values())
        vec = self.faults.inject_vector(self.engine_steps, self.n_slots,
                                        occupied)
        if not vec.any():
            return None
        return to_device(vec, self.device)

    # ------------------------------------------------------------------- step
    def step(self) -> Dict[int, Any]:
        """One engine step for every active slot, after the lifecycle
        prologue (deadlines, cache pressure, controller, queue admission —
        see ``pump()``; a planned transient fault raises
        ``EngineFault(transient=True)`` before any mutation).  Vanilla:
        one batched decode, returns {uid: new token}.  Speculative: one
        propose/verify/rollback window, returns {uid: [tokens]} — 1 to
        γ+1 tokens per request, each what vanilla greedy decode would
        emit.  Quarantined requests emit nothing and are absent from the
        dict.  With a ``cost_model``, the step's modeled cost is published
        as ``last_step_cost_ms``."""
        self._step_prefill_tokens = 0
        self._step_decode_calls = 0
        self._step_draft_calls = 0
        self._step_verify_tokens = 0
        out = self._step_inner()
        if self.cost_model is not None:
            self.last_step_cost_ms = self.cost_model.cost_ms(
                prefill_tokens=self._step_prefill_tokens,
                decode_calls=self._step_decode_calls,
                draft_calls=self._step_draft_calls,
                verify_tokens=self._step_verify_tokens)
        return out

    @torch.no_grad()
    def _step_inner(self) -> Dict[int, Any]:
        self._tick()
        if self.chunked is not None:
            # interleave pending prefill chunks BEFORE decode: completed
            # groups join `active` and decode this very step
            self._process_chunks()
        tel = self.telemetry
        if tel is not None:
            tel.sample("queue_depth", self.engine_steps, len(self.queue))
            tel.sample("active_slots", self.engine_steps, len(self.active))
            if self._paged:
                tel.sample("pages_in_use", self.engine_steps,
                           self.allocator.pages_in_use)
        if not self.active:
            if len(self.queue) or self._prefill_groups:
                # idle step with pending work: step-indexed fault plans
                # must still elapse, or inadmissible work would livelock
                self.engine_steps += 1
            return {}
        if self._paged:
            # reserve (zeroed, private) pages for every K/V write this step
            # issues — one for vanilla decode, the whole window for
            # speculation — then push the dirty table mirror
            self._ensure_capacity(
                self._gamma_eff + 1
                if self.spec is not None and self._spec_enabled else 1)
            if not self.active:
                if len(self.queue) or self._prefill_groups:
                    self.engine_steps += 1
                return {}
            self._sync_tables()
        if self.spec is not None and self._spec_enabled:
            return self._spec_step()
        step_idx = self.engine_steps
        slot_of = {uid: r.slot for uid, r in self.active.items()}
        t0 = tel.now() if tel is not None else 0.0
        iv = self._inject_vec()
        self.call_shapes["decode"].add((self.n_slots,))
        self.sentinel.observe("decode", (self.n_slots,))
        if self.spec is not None:
            self.call_shapes["draft_decode"].add((self.n_slots,))
            self.sentinel.observe("draft_decode", (self.n_slots,))
            self._step_draft_calls += 1
        nxt, nf_h, self.cache, self.draft_cache = self._decode_batch(
            self.cache, self.draft_cache, iv)
        self._step_decode_calls += 1
        emitted = {}
        for uid, req in list(self.active.items()):
            s = req.slot
            if nf_h is not None and nf_h[s] > 0:
                # non-finite row: quarantine ONLY this request; the other
                # rows of the same batched decode are unaffected
                self._quarantine(req, "decode", int(nf_h[s]))
                continue
            t = int(nxt[s])
            emitted[uid] = t
            self._append_token(req, t)
        self.engine_steps += 1
        self.emitted_tokens += len(emitted)
        if tel is not None:
            tel.on_step("decode", {u: 1 for u in emitted}, slot_of,
                        tel.now() - t0, step_idx)
        return emitted

    @_meshed
    def _decode_batch(self, cache: List, draft_cache, iv):
        """The vanilla decode step's device work over ``cache`` (and, when
        given — speculation's spec_off rung — ``draft_cache``): the tokens
        uploaded, one batched decode, the fault vector ``iv`` added, and
        the one transfer of ``_sample``.  Returns (tokens, guard counts or
        None, cache, draft_cache) — the engine's caches, or the contract
        gate's clones of the target's (the reference's gate lowers the
        target's decode alone)."""
        toks = self._local(to_device(self.last_token, self.device))
        with nn.activation_quant(self.act_dtype), \
                dctx.rows_over_dp(self._rows is not None):
            logits, out = api.decode_step(self.params, self.cfg, toks,
                                          self._slot_view(cache))
            cache = self._slot_unview(out, cache)
            if draft_cache is not None:
                # spec_off rung: advance the draft cache with the SAME
                # token so both caches stay uniformly filled and
                # re-enabling speculation is seamless
                _, out = api.decode_step(self.draft_params, self.cfg, toks,
                                         self._slot_view(draft_cache))
                draft_cache = self._slot_unview(out, draft_cache)
        if iv is not None:
            logits = logits + self._local(iv).to(logits.dtype)[:, None]
        nxt, nf_h = self._sample(logits, self._rows is not None)
        return nxt, nf_h, cache, draft_cache

    @_meshed
    def _spec_step(self) -> Dict[int, List[int]]:
        """One speculation window: γ+1 draft decodes (the last one
        write-only, so both caches advance to fill+γ+1), ONE target span
        verify, greedy acceptance, then one rollback of both caches to
        fill+accepted.  Retirement (EOS / budget / cache full) applies
        token by token in emission order.  A non-finite verify row (guards
        on) emits nothing: the slot rolls back to empty and the request is
        quarantined.  The window's drafts, greedy tokens and guard counts
        reach the host in one transfer."""
        # γ_eff: the controller's spec_half rung halves the window
        gamma = self._gamma_eff
        cfg = self.cfg
        tel = self.telemetry
        step_idx = self.engine_steps
        slot_of = {uid: r.slot for uid, r in self.active.items()}
        accepted_ks: List[int] = []
        t0 = tel.now() if tel is not None else 0.0
        # per-slot fill BEFORE the window: the window itself writes the
        # pending last token's K/V
        base_fill = {uid: self._fill(r) for uid, r in self.active.items()}
        # this data rank's slot rows (all of them without a mesh)
        last = self._local(to_device(self.last_token, self.device))
        iv = self._inject_vec()
        self.call_shapes["draft_decode"].add((self.n_slots,))
        self.call_shapes["verify"].add((self.n_slots, gamma + 1))
        cur, d_cols = last, []
        dview = self._slot_view(self.draft_cache)
        with nn.activation_quant(self.act_dtype), \
                dctx.rows_over_dp(self._rows is not None):
            for _ in range(gamma):
                self.sentinel.observe("draft_decode", (self.n_slots,))
                dlogits, dview = api.decode_step(
                    self.draft_params, cfg, cur, dview)
                cur = dlogits.argmax(dim=-1)
                d_cols.append(cur)
            # write-only catch-up: feed d_γ so the draft cache holds it if
            # the whole window is accepted (its logits are not read)
            self.sentinel.observe("draft_decode", (self.n_slots,))
            _, dview = api.decode_step(self.draft_params, cfg, cur, dview)
            self.draft_cache = self._slot_unview(dview, self.draft_cache)
            drafts_t = torch.stack(d_cols, dim=1)           # (n_slots, γ)
            span = torch.cat([last[:, None], drafts_t], dim=1)
            self.sentinel.observe("verify", (self.n_slots, gamma + 1))
            vlogits, out = api.decode_span(self.params, cfg, span,
                                           self._slot_view(self.cache))
            self.cache = self._slot_unview(out, self.cache)
        self._step_draft_calls += gamma + 1
        self._step_verify_tokens += gamma + 1
        if iv is not None:
            vlogits = vlogits + self._local(iv).to(vlogits.dtype)[:, None,
                                                                  None]
        cols = [drafts_t, vlogits.argmax(dim=-1)]
        if self.guards:
            cols.append(nonfinite_rows(vlogits).to(drafts_t.dtype)[:, None])
        host = torch.cat(cols, dim=1)
        host = to_host(coll.gather_dp(host, self.mesh)
                       if self._rows is not None else host)
        drafts, greedy = host[:, :gamma], host[:, gamma:2 * gamma + 1]
        nf_h = host[:, -1] if self.guards else None

        emitted: Dict[int, List[int]] = {}
        lens = np.zeros((self.n_slots,), np.int32)   # 0 = free/retired slot
        for uid, req in list(self.active.items()):
            s = req.slot
            if nf_h is not None and nf_h[s] > 0:
                # mid-window quarantine: no token of this window can be
                # trusted, so emit nothing; lens[s] = 0 clears the slot in
                # the rollback below before it is recycled
                self._quarantine(req, "verify", int(nf_h[s]))
                lens[s] = 0
                continue
            k, toks = speculative.accept_greedy(drafts[s], greedy[s])
            appended: List[int] = []
            for t in toks:
                if self._fill(req) >= self.max_len:
                    # the slot cache is full before the budget: later span
                    # rows fell past the cache end, so stop at exactly the
                    # token vanilla decode would
                    self._retire(req, RequestState.TRUNCATED)
                    break
                self._append_token(req, t)
                appended.append(t)
                if req.done:
                    break
            emitted[uid] = appended
            self.spec_drafted += gamma
            self.spec_accepted += k
            self.emitted_tokens += len(appended)
            accepted_ks.append(k)
            lens[s] = 0 if req.done else base_fill[uid] + len(appended)
        self.engine_steps += 1
        self.cache = self._rollback(self.cache, lens)
        self.draft_cache = self._rollback(self.draft_cache, lens)
        if tel is not None:
            tel.on_step("spec", {u: len(v) for u, v in emitted.items()},
                        slot_of, tel.now() - t0, step_idx,
                        window=speculative.window_summary(gamma,
                                                          accepted_ks))
            for k in accepted_ks:
                tel.registry.histogram(
                    "spec_accepted_per_window", lo=0.5,
                    hi=float(max(gamma + 1, 2)), per_decade=16).observe(k)
        return emitted

    def run_to_completion(self, max_steps: int = 256, strict: bool = True,
                          retry: Optional[RetryPolicy] = None) -> List[int]:
        """Step until every submitted request is terminal (the queue
        drains through ``pump()`` inside ``step()``).  Returns the uids
        still in flight when ``max_steps`` runs out ([] == all finished);
        with ``strict`` that raises ``IncompleteRun`` with the partial
        outputs and lifecycle states.  ``retry=RetryPolicy(...)`` absorbs
        transient ``EngineFault``s (bounded attempts, backoff); without
        it they propagate."""
        consecutive_faults = 0
        steps = 0
        while steps < max_steps:
            if (not self.active and not len(self.queue)
                    and not self._prefill_groups):
                return []
            try:
                self.step()
            except EngineFault as e:
                if retry is None or not e.transient:
                    raise
                consecutive_faults += 1
                if consecutive_faults >= retry.max_attempts:
                    raise
                backoff = (retry.backoff_s
                           * retry.multiplier ** (consecutive_faults - 1))
                if backoff > 0:
                    retry.sleep(backoff)
                continue
            consecutive_faults = 0
            steps += 1
        prefilling = [r for g in self._prefill_groups for r in g.live()]
        unfinished = sorted(set(self.active) | set(self.queue.uids())
                            | {r.uid for r in prefilling})
        if unfinished and strict:
            reqs = dict(self.active)
            reqs.update({r.uid: r for r in self.queue.requests()})
            reqs.update({r.uid: r for r in prefilling})
            raise IncompleteRun(
                f"run_to_completion: max_steps={max_steps} exhausted with "
                f"{len(unfinished)} requests not terminal (uids "
                f"{unfinished}); partial outputs and lifecycle states "
                f"attached to this error",
                partial={u: list(reqs[u].tokens) for u in unfinished},
                states={u: reqs[u].state for u in unfinished})
        return unfinished

    # ------------------------------------------------------------------ stats
    def take_finished(self) -> Dict[int, Request]:
        """Drain and return retired requests."""
        out, self.finished = self.finished, {}
        return out

    def stats(self) -> Dict[str, Any]:
        s = self.bucketing.stats
        out = {
            "prefill_traces": self.prefill_traces,
            "decode_traces": len(self.call_shapes["decode"]),
            "buckets": list(self.bucketing.buckets()),
            "bucket_hits": s.hits,
            "bucket_misses": s.misses,
            "bucket_hit_rate": s.hit_rate,
            "act_dtype": self.act_dtype or "f32",
            "mesh": (dctx.mesh_shape(self.mesh) if self.mesh is not None
                     else None),
            "emitted_tokens": self.emitted_tokens,
            "engine_steps": self.engine_steps,
            "tokens_per_step": (self.emitted_tokens / self.engine_steps
                                if self.engine_steps else 0.0),
            "queued": len(self.queue),
            "queue_depth": self.queue.depth,
            "queue_peak_depth": self.queue.peak_depth,
            "guards": self.guards,
            "on_pressure": self.on_pressure,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "admission_rejections": self.admission_rejections,
            "lifecycle": {st.value: self.state_counts.get(st.value, 0)
                          for st in sorted(TERMINAL_STATES,
                                           key=lambda s: s.value)},
        }
        if self._paged:
            # bytes straight off the live pools: bytes per page (all
            # layers, pools + scales) x occupancy, beside what the
            # contiguous fp layout would pin
            ps = self.page_size
            fp_size = torch.empty((), dtype=self._cache_dtype).element_size()
            per_page = per_tok_fp = 0
            for c in self.cache:
                for f in _pool_leaves(c):
                    pool, sc = getattr(c, f), getattr(c, _SCALE_OF[f])
                    feat = int(np.prod(pool.shape[2:]))
                    per_page += ps * feat * pool.element_size()
                    per_tok_fp += feat * fp_size
                    if sc is not None:
                        per_page += ps * sc.element_size()
            a = self.allocator
            out["paged"] = {
                "page_size": ps,
                "n_pages": a.n_pages,
                "pages_in_use": a.pages_in_use,
                "pages_free": a.n_free,
                "pool_utilization": a.pages_in_use / a.n_pages,
                "peak_pages_in_use": self.peak_pages_in_use,
                "peak_pages_per_request": self.peak_pages_per_request,
                "kv_dtype": self.kv_dtype or str(self._cache_dtype).replace(
                    "torch.", ""),
                "bytes_per_page": per_page,
                "bytes_resident": a.pages_in_use * per_page,
                "bytes_pool": a.n_pages * per_page,
                "bytes_contiguous_fp": (self.n_slots * self.max_len
                                        * per_tok_fp),
                "prefix_hits": self.prefix_hits,
                "prefix_shared_tokens": self.prefix_shared_tokens,
                "cow_copies": self.cow_copies,
                "page_evictions": self.page_evictions,
                "pages_allocated_total": a.pages_allocated_total,
                "pages_freed_total": a.pages_freed_total,
                "registry_entries": (len(self.prefix_registry)
                                     if self.prefix_registry is not None
                                     else 0),
            }
        if self.spec is not None:
            out.update({
                "spec_gamma": self.spec.gamma,
                "spec_gamma_eff": self._gamma_eff,
                "spec_enabled": self._spec_enabled,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                # fraction of proposed draft tokens the target kept
                "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                    if self.spec_drafted else 0.0),
                "draft_prefill_traces": len(
                    self.call_shapes["draft_prefill"]),
                "draft_decode_traces": len(self.call_shapes["draft_decode"]),
                "verify_traces": len(self.call_shapes["verify"]),
            })
        if self.chunked is not None:
            out["chunked"] = {
                "chunk_tokens": self.chunked.chunk_tokens,
                "budget_tokens": self.chunked.budget_tokens,
                "chunk_prefill_traces": len(self.call_shapes["chunk_prefill"]),
                "draft_chunk_prefill_traces": len(
                    self.call_shapes["draft_chunk_prefill"]),
                "chunks_processed": self.chunks_processed,
                "groups_pending": len(self._prefill_groups),
                "prefilling": self.pending_prefills,
            }
        if self.last_step_cost_ms is not None:
            out["last_step_cost_ms"] = self.last_step_cost_ms
        if self.controller is not None:
            out["controller"] = self.controller.stats()
        return out

    def reset_peaks(self) -> None:
        """Drop high-water marks (queue depth, page peaks) to CURRENT
        occupancy.  Back-to-back A/B replays share one process; without
        this the second run's report inherits the first run's peaks."""
        self.queue.reset_peaks()
        if self._paged:
            self.peak_pages_in_use = self.allocator.pages_in_use
            self.peak_pages_per_request = max(
                (len(p) for p in self._req_pages.values()), default=0)

    def metrics(self) -> MetricsRegistry:
        """Every ``stats()`` number projected onto the telemetry registry
        as ``serve.*`` gauges (joining the span-derived histograms and
        timelines when a recorder is attached)."""
        reg = (self.telemetry.registry if self.telemetry is not None
               else MetricsRegistry())
        return registry_from_stats(self.stats(), reg)
