"""Batched serving engine (port of ``repro.serve.engine``): slot-based
continuous batching over a fixed-size decode batch, with bucketed prefill
admission into free slots, self-speculative decoding and a paged KV cache.

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

Self-speculative decoding (``draft_params=`` — the same checkpoint
quantized at a lower bit-width from the same calibration, see
``launch.quantize.claq_quantize_with_draft`` — and ``spec=SpecConfig(γ)``):
``step()`` becomes a propose/verify/rollback window (serve/speculative.py):
γ+1 draft decodes, ONE target span verify (``models.api.decode_span``),
greedy acceptance, and a per-slot rollback of both caches
(``_rollback_tail``).  Retirement applies token by token in emission
order, so a request retires at the token vanilla decode would retire it
at.  The draft gets its own plans (``draft_plan_bn``/``draft_plan_bk``
cap its tiles) and its own cache, prefilled beside the target's.

Paged KV cache (``kv_layout="paged"``): each layer owns a page pool
``(n_pages + 1, page_size, ...)`` (the last row is the scratch page) and
every slot a page-table row, mirrored on the host and copied to the device
before a step that reads it (``_sync_tables``).  Pages are allocated on
demand — at admission for the prompt (all or nothing: ``PoolExhausted``
leaves nothing admitted), before each step for the step's K/V writes
(``_ensure_capacity``) — zeroed when fresh, and freed at retirement.
Prefill stays contiguous; fragments are scattered into pages afterwards
(``_paged_insert``).  Paged fp decode is bit-identical to contiguous
decode: the gathered view has the contiguous cache's shape.
``kv_dtype="int8"`` stores pages quantized per token row (scale/2 error
per element, about 1/4 of fp32's bytes).  Requests sharing a prompt
prefix share physical pages (``PrefixRegistry``, refcounted) and copy on
write at their first write into a shared page.  Under pool pressure at
decode time the port does what the reference does with
``on_pressure="truncate"``: registry entries are evicted first, then the
starved request retires TRUNCATED with ``pool_exhausted`` diagnostics (the
reference's preemption under pool pressure comes with the lifecycle
slice).

PyTorch runs eagerly, so there are no traces to count: ``prefill_traces``
is the number of distinct (batch, bucket) prefill shapes run, and the
other ``*_traces`` counters of ``stats()`` the distinct shapes of their
calls — the quantities the reference bounds by its trace counts.

Port note — not accepted yet (each queued in ROADMAP.md): a device mesh
(``mesh``), chunked prefill (``chunked_prefill``), numeric guards
(``guards``), fault injection (``faults``), the queued admission path with
backpressure, priorities, deadlines and preemption (``submit``,
``queue_depth``, ``on_pressure``, ``clock``), the overload controller and
cost model (``controller``, ``cost_model``), telemetry (``telemetry``) and
the contract checker (``verify_contracts``).  Passing any of them raises
``TypeError``; a family other than dense raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.kernels import ops as kops
from repro_torch.kernels.plan import prepare_tree
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tf

from . import lifecycle as lc
from . import speculative
from .bucketing import BucketingPolicy
from .lifecycle import (AdmissionRejected, IncompleteRun, RequestState,
                        TERMINAL_STATES)
from .paging import PageAllocator, PoolExhausted, PrefixRegistry
from .speculative import SpecConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    state: RequestState = RequestState.QUEUED
    diagnostics: Optional[Dict[str, Any]] = None

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def truncated(self) -> bool:
        return self.state is RequestState.TRUNCATED

    def transition(self, new_state: RequestState) -> None:
        lc.transition(self, new_state)


def _masked_group_insert(full: List[L.KVCache], frag: List[L.KVCache],
                         slots: Sequence[int], lens: Sequence[int],
                         masked: bool) -> List[L.KVCache]:
    """Copy the first ``len(slots)`` rows of a prefill fragment into the
    batched cache at ``slots`` (in place), keeping only each row's first
    ``lens[r]`` positions when ``masked`` (padded admission): the padded
    K/V tail is zeroed and the fill counter pinned to the true length, so
    the batched cache is what an unpadded prefill would have left."""
    B = len(slots)
    dev = full[0].k.device
    slots_t = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
    lens_t = torch.as_tensor(list(lens), dtype=torch.int32, device=dev)
    out = []
    for fl, fr in zip(full, frag):
        k, v = fr.k[:B], fr.v[:B]
        if masked:
            keep = (torch.arange(k.shape[1], device=dev)[None, :]
                    < lens_t[:, None])[:, :, None, None]
            k = torch.where(keep, k, torch.zeros((), dtype=k.dtype,
                                                 device=dev))
            v = torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                                 device=dev))
            new_len = lens_t
        else:
            new_len = fr.length[:B]
        fl.k[slots_t] = k
        fl.v[slots_t] = v
        length = fl.length.clone()
        length[slots_t] = new_len.to(length.dtype)
        out.append(L.KVCache(fl.k, fl.v, length))
    return out


def _rollback_tail(cache: List, new_lens) -> List:
    """Rewind every slot's fill counter to ``new_lens`` ((B,) ints) and,
    in a contiguous cache, zero the K/V positions at or past it, in place
    — the per-slot rollback a rejected speculation window needs (a slot
    whose length is 0 is cleared).  The rolled-back cache is bit-identical
    to one that never saw the tail (the tail past a slot's fill is zero
    from init and the masked insert).  A paged cache rewinds by its fill
    counter alone: the tail's rows stay in their pages, hidden by the mask
    and overwritten by the next window."""
    dev = cache[0].length.device
    n = torch.as_tensor(np.asarray(new_lens), dtype=torch.int32, device=dev)
    out = []
    for c in cache:
        if isinstance(c, L.KVCache):
            drop = ~(torch.arange(c.k.shape[1], device=dev)[None, :]
                     < n[:, None])[:, :, None, None]
            c.k.masked_fill_(drop, 0)
            c.v.masked_fill_(drop, 0)
        out.append(c._replace(length=n))
    return out


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
                 kv_layout: str = "contiguous",
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 share_prefixes: bool = True, device="cuda"):
        """``params``: a ``Transformer`` (``models.api.init_params`` or
        ``convert.from_numpy_tree``) on ``device``.  ``dtype`` is the KV
        cache's (of the prefill fragments, and of fp pages).  ``prepare``
        compiles quantized kernels into plans (in place); ``plan_bn`` /
        ``plan_bk`` cap the plan's block sizes.  ``act_dtype``: None/"f32",
        or "int8" (needs ``prepare``).  ``draft_params`` + ``spec``:
        self-speculative decoding.  ``kv_layout="paged"`` with
        ``page_size`` (default 16; divides ``max_len``), ``kv_pages``
        (default: contiguous capacity), ``kv_dtype`` (None/"f32" or
        "int8") and ``share_prefixes``: the paged KV cache."""
        if cfg.family == "encdec":
            raise NotImplementedError(
                "ServingEngine serves decoder-only families; encdec "
                "admission needs a frames input and a length-masked encoder")
        act_dtype = kops.normalize_act_dtype(act_dtype)
        if act_dtype is not None and not prepare:
            raise ValueError(
                "act_dtype='int8' needs ahead-of-time plans — drop "
                "prepare=False (the int8 path runs on prepared leaves only)")
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
        tf.validate_family(cfg)
        self.device = dev_lib.resolve(device)
        prep_kw = {}
        if plan_bn is not None:
            prep_kw["bn"] = plan_bn
        if plan_bk is not None:
            prep_kw["bk"] = plan_bk
        self.params = prepare_tree(params, **prep_kw) if prepare else params
        self.cfg = cfg
        self.act_dtype = act_dtype
        self.n_slots = n_slots
        self.max_len = max_len
        self.bucketing = BucketingPolicy(min_bucket=min_bucket,
                                         max_len=max_len, enabled=bucketing)
        self._cache_dtype = dtype
        self._cache_kw: Dict[str, Any] = {}
        if self._paged:
            self._cache_kw = dict(page_size=self.page_size,
                                  n_pages=self.n_pages,
                                  kv_dtype=self.kv_dtype)
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
        # "draft_decode", "verify"): the port's counterpart of the
        # reference's per-jit trace counters
        self.call_shapes: Dict[str, set] = collections.defaultdict(set)
        self.emitted_tokens = 0
        self.engine_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.state_counts: collections.Counter = collections.Counter()

    def _make_slot_cache(self) -> List:
        return api.make_cache(self.cfg, self.n_slots, self.max_len,
                              dtype=self._cache_dtype, device=self.device,
                              **self._cache_kw)

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
                table.copy_(host)
        self._tables_dirty = False

    def _map_pools(self, fn) -> None:
        """Apply ``fn`` in place to every pool and scale tensor of the
        target (and draft) cache: the plumbing of page zeroing and COW."""
        for cache in self._caches():
            for c in cache:
                for t in (c.kp, c.vp, c.k_scale, c.v_scale):
                    if t is not None:
                        fn(t)

    def _zero_pages(self, pages: Sequence[int]) -> None:
        """Zero freshly allocated pages in both caches: every unwritten
        cache row stays exactly zero, so a recycled page never leaks its
        previous holder's rows, and masked rows add exactly 0.0."""
        idx = torch.as_tensor(sorted(set(int(p) for p in pages)),
                              dtype=torch.long, device=self.device)

        def zero(t):
            t[idx] = 0
        self._map_pools(zero)

    def _copy_pages(self, pairs: Sequence) -> None:
        """Copy-on-write: duplicate the pool (and scale) rows of shared
        pages into fresh private ones, target and draft cache alike."""
        olds = torch.as_tensor([int(o) for o, _ in pairs], dtype=torch.long,
                               device=self.device)
        news = torch.as_tensor([int(n) for _, n in pairs], dtype=torch.long,
                               device=self.device)

        def copy(t):
            t[news] = t[olds]
        self._map_pools(copy)

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

    def _plan_pages(self, req: Request, n_tokens: int):
        """Reserve the pages covering ``n_tokens`` resident positions for
        one request: shared prefix pages first (retained read-only from
        the registry), fresh private pages for the rest.  Returns
        ``(pages, table_row, write_row)`` — ``write_row`` marks the blocks
        the admission scatter may write (scratch everywhere else: shared
        pages stay read-only until COW).  All-or-nothing: on
        ``PoolExhausted`` no reference survives."""
        ps, scratch = self.page_size, self.allocator.scratch
        mp = self.max_len // ps
        nb = -(-n_tokens // ps)
        shared: List[int] = []
        if self.prefix_registry is not None:
            _, shared = self.prefix_registry.lookup(req.prompt)
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
        """Drop a retiring request's page references and point its table
        row back at scratch.  The stale device rows stay until the pages
        are reallocated (and zeroed) — the mask already hides them."""
        if not self._paged:
            return
        pages = self._req_pages.pop(req.uid, None)
        if pages:
            self.allocator.free(pages)
        if req.slot >= 0:
            self._tables[req.slot, :] = self.allocator.scratch
            self._tables_dirty = True

    def _paged_insert(self, cache: List, frag: List[L.KVCache],
                      slots: Sequence[int], lens: Sequence[int],
                      wrows) -> List:
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
        wt = torch.as_tensor(np.asarray(wrows).reshape(-1), dtype=torch.long,
                             device=dev)
        slots_t = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
        keep = (torch.arange(self.max_len, device=dev)[None, :]
                < lens_t[:, None])[:, :, None, None]
        out = []
        for pl, fr in zip(cache, frag):
            for pool, scale, src in ((pl.kp, pl.k_scale, fr.k),
                                     (pl.vp, pl.v_scale, fr.v)):
                v = torch.where(keep, src[:B], torch.zeros((), dtype=src.dtype,
                                                           device=dev))
                v = v.reshape((B * mp, ps) + v.shape[2:])
                if scale is None:
                    pool[wt] = v.to(pool.dtype)
                else:
                    xq, sc = kops.quantize_activations(
                        v.reshape(B * mp, ps, -1).float())
                    pool[wt] = xq.reshape(v.shape)
                    scale[wt] = sc[..., 0]
            length = pl.length.clone()
            length[slots_t] = lens_t
            out.append(pl._replace(length=length))
        return out

    # ------------------------------------------------------------------ admit
    @staticmethod
    def _fill(req: Request) -> int:
        """Slot-cache positions in use: the prompt plus one K/V write per
        decode step so far (the pending last token's write belongs to the
        next step)."""
        return len(req.prompt) + len(req.tokens) - 1

    def _make_request(self, prompt: Sequence[int], max_new_tokens: int,
                      eos_id: Optional[int]) -> Request:
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
        req = Request(self._uid, prompt, max_new_tokens, eos_id)
        self._uid += 1
        return req

    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                    eos_id: Optional[int] = None) -> int:
        return self.add_requests([prompt], max_new_tokens, eos_id)[0]

    def add_requests(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: int = 16,
                     eos_id: Optional[int] = None) -> List[int]:
        """Admit prompts directly into free slots; those sharing a length
        bucket are prefilled in one batched call.  Returns uids in prompt
        order (an immediate EOS or a one-token budget retires at
        admission — look in ``finished``).  A paged engine whose pool
        cannot hold every prompt raises ``PoolExhausted`` and admits
        none."""
        if len(prompts) > len(self.free):
            raise AdmissionRejected(
                f"need {len(prompts)} free slots, have {len(self.free)}")
        reqs = [self._make_request(p, max_new_tokens, eos_id)
                for p in prompts]
        self._admit(reqs)
        return [r.uid for r in reqs]

    def _prefill(self, params, toks: np.ndarray, lens: np.ndarray):
        """Prefill a (Bb, bucket) token block into a fresh contiguous
        fragment; returns (logits at each row's last true token, frag)."""
        frag = api.make_cache(self.cfg, toks.shape[0], self.max_len,
                              dtype=self._cache_dtype, device=self.device)
        with nn.activation_quant(self.act_dtype):
            return api.prefill_step(
                params, self.cfg,
                {"tokens": torch.as_tensor(toks, device=self.device)},
                frag, logits_at=torch.as_tensor(lens - 1,
                                                device=self.device))

    @torch.no_grad()
    def _admit(self, reqs: List[Request]) -> None:
        groups: Dict[int, List[int]] = {}
        for i, req in enumerate(reqs):
            groups.setdefault(self.bucketing.bucket_for(len(req.prompt)),
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
        for bucket, idxs in groups.items():
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
            logits, frag = self._prefill(self.params, toks, lens)
            dfrag = None
            if self.spec is not None:
                # the draft needs the prompt in ITS cache too: its first
                # proposal continues from the target-sampled first token
                self.call_shapes["draft_prefill"].add((Bb, bucket))
                _, dfrag = self._prefill(self.draft_params, toks, lens)
            firsts = logits.argmax(dim=-1).cpu().numpy()
            slots = [self.free.pop(0) for _ in idxs]
            true_lens = lens[:B].tolist()
            if self._paged:
                wrows = np.stack([plans[reqs[i].uid][2] for i in idxs])
                self.cache = self._paged_insert(self.cache, frag, slots,
                                                true_lens, wrows)
                if dfrag is not None:
                    self.draft_cache = self._paged_insert(
                        self.draft_cache, dfrag, slots, true_lens, wrows)
                for r, i in enumerate(idxs):
                    req = reqs[i]
                    pages, row, _ = plans[req.uid]
                    self._tables[slots[r]] = row
                    self._req_pages[req.uid] = list(pages)
                    if self.prefix_registry is not None:
                        self.prefix_registry.register(req.prompt, pages)
                    self._note_page_peaks(req)
                self._tables_dirty = True
            else:
                masked = self.bucketing.enabled
                self.cache = _masked_group_insert(self.cache, frag, slots,
                                                  true_lens, masked)
                if dfrag is not None:
                    self.draft_cache = _masked_group_insert(
                        self.draft_cache, dfrag, slots, true_lens, masked)
            for r, i in enumerate(idxs):
                req = reqs[i]
                req.slot = slots[r]
                req.transition(RequestState.RUNNING)
                self.active[req.uid] = req
                self._append_token(req, int(firsts[r]))

    # -------------------------------------------------------------- lifecycle
    def _retire(self, req: Request,
                state: RequestState = RequestState.FINISHED,
                diagnostics: Optional[Dict[str, Any]] = None) -> None:
        if diagnostics is not None:
            req.diagnostics = diagnostics
        req.transition(state)
        self._release_pages(req)
        if req.slot >= 0:
            self.free.append(req.slot)
            req.slot = -1
        self.active.pop(req.uid, None)
        self.finished[req.uid] = req
        self.state_counts[state.value] += 1

    def _append_token(self, req: Request, t: int) -> None:
        """Append a sampled token and apply retirement (budget / EOS) — the
        one place the check lives, prefill's first token included."""
        req.tokens.append(t)
        self.last_token[req.slot] = t
        if (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and t == req.eos_id)):
            self._retire(req, RequestState.FINISHED)

    # ---------------------------------------------------------- decode pages
    def _alloc_decode_page(self, req: Request) -> int:
        """One fresh page for a running request's next K/V write, evicting
        registry entries first; ``PoolExhausted`` propagates when none
        remain (the reference's preemption under pool pressure comes with
        the lifecycle slice)."""
        page = self._alloc_evicting(1)[0]
        self._note_page_peaks()
        return page

    def _reserve_blocks(self, req: Request, horizon: int,
                        cow: List, fresh: List) -> None:
        """Make every table block the next ``horizon`` K/V writes of this
        request touch PRIVATE and allocated: scratch blocks get fresh
        pages (queued in ``fresh`` for zeroing), shared blocks (refcount >
        1) are replaced by private copies (queued in ``cow``) with the
        shared reference dropped — copy-on-write at the first write into
        shared territory.  Entries are uid-tagged: a later retirement may
        free and recycle pages queued earlier, and the caller filters
        stale entries by current ownership."""
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
        exhaustion the starved request retires TRUNCATED with
        ``pool_exhausted`` diagnostics — typed, observable backpressure."""
        if not self._paged or not self.active:
            return
        cow: List = []
        fresh: List = []
        for uid in sorted(self.active):
            req = self.active[uid]
            try:
                self._reserve_blocks(req, horizon, cow, fresh)
            except PoolExhausted:
                self._retire(req, RequestState.TRUNCATED, diagnostics={
                    "kind": "pool_exhausted",
                    "pages_in_use": self.allocator.pages_in_use,
                    "n_pages": self.allocator.n_pages,
                    "engine_step": self.engine_steps})
        # a retirement mid-loop may have freed (and recycled) queued pages;
        # only zero/copy pages their planner still owns
        own = {u: set(p) for u, p in self._req_pages.items()}
        zs = [p for u, p in fresh if p in own.get(u, ())]
        pairs = [(o, n) for u, o, n in cow if n in own.get(u, ())]
        if zs:
            self._zero_pages(zs)
        if pairs:
            self._copy_pages(pairs)

    # ------------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> Dict[int, Any]:
        """One engine step for every active slot.  Requests whose slot
        cache is full retire TRUNCATED first.  Vanilla: one batched
        decode, returns {uid: new token}.  Speculative: one
        propose/verify/rollback window, returns {uid: [tokens]} — 1 to
        γ+1 tokens per request, each what vanilla greedy decode would
        emit."""
        for req in list(self.active.values()):
            if self._fill(req) >= self.max_len:
                self._retire(req, RequestState.TRUNCATED)
        if not self.active:
            return {}
        if self._paged:
            # reserve (zeroed, private) pages for every K/V write this step
            # issues — one for vanilla decode, the whole window for
            # speculation — then push the dirty table mirror
            self._ensure_capacity(self.spec.gamma + 1
                                  if self.spec is not None else 1)
            if not self.active:
                return {}
            self._sync_tables()
        if self.spec is not None:
            return self._spec_step()
        self.call_shapes["decode"].add((self.n_slots,))
        toks = torch.as_tensor(self.last_token, device=self.device)
        with nn.activation_quant(self.act_dtype):
            logits, self.cache = api.decode_step(self.params, self.cfg, toks,
                                                 self.cache)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        emitted = {}
        for uid, req in list(self.active.items()):
            t = int(nxt[req.slot])
            emitted[uid] = t
            self._append_token(req, t)
        self.engine_steps += 1
        self.emitted_tokens += len(emitted)
        return emitted

    def _spec_step(self) -> Dict[int, List[int]]:
        """One speculation window: γ+1 draft decodes (the last one
        write-only, so both caches advance to fill+γ+1), ONE target span
        verify, greedy acceptance, then one rollback of both caches to
        fill+accepted.  Retirement (EOS / budget / cache full) applies
        token by token in emission order."""
        gamma = self.spec.gamma
        cfg = self.cfg
        # per-slot fill BEFORE the window: the window itself writes the
        # pending last token's K/V
        base_fill = {uid: self._fill(r) for uid, r in self.active.items()}
        last = torch.as_tensor(self.last_token, device=self.device)
        self.call_shapes["draft_decode"].add((self.n_slots,))
        self.call_shapes["verify"].add((self.n_slots, gamma + 1))
        cur, d_cols = last, []
        with nn.activation_quant(self.act_dtype):
            for _ in range(gamma):
                dlogits, self.draft_cache = api.decode_step(
                    self.draft_params, cfg, cur, self.draft_cache)
                cur = dlogits.argmax(dim=-1)
                d_cols.append(cur)
            # write-only catch-up: feed d_γ so the draft cache holds it if
            # the whole window is accepted (its logits are not read)
            _, self.draft_cache = api.decode_step(self.draft_params, cfg, cur,
                                                  self.draft_cache)
            drafts_t = torch.stack(d_cols, dim=1)           # (n_slots, γ)
            span = torch.cat([last[:, None], drafts_t], dim=1)
            vlogits, self.cache = api.decode_span(self.params, cfg, span,
                                                  self.cache)
        drafts = drafts_t.cpu().numpy()
        greedy = vlogits.argmax(dim=-1).cpu().numpy()

        emitted: Dict[int, List[int]] = {}
        lens = np.zeros((self.n_slots,), np.int32)   # 0 = free/retired slot
        for uid, req in list(self.active.items()):
            s = req.slot
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
            lens[s] = 0 if req.done else base_fill[uid] + len(appended)
        self.engine_steps += 1
        self.cache = _rollback_tail(self.cache, lens)
        self.draft_cache = _rollback_tail(self.draft_cache, lens)
        return emitted

    def run_to_completion(self, max_steps: int = 256,
                          strict: bool = True) -> List[int]:
        """Step until every request is terminal.  Returns the uids still
        running when ``max_steps`` runs out ([] == all finished); with
        ``strict`` that raises ``IncompleteRun`` with the partial outputs."""
        for _ in range(max_steps):
            if not self.active:
                return []
            self.step()
        unfinished = sorted(self.active)
        if unfinished and strict:
            raise IncompleteRun(
                f"run_to_completion: max_steps={max_steps} exhausted with "
                f"{len(unfinished)} requests not terminal (uids "
                f"{unfinished}); partial outputs and lifecycle states "
                f"attached to this error",
                partial={u: list(self.active[u].tokens) for u in unfinished},
                states={u: self.active[u].state for u in unfinished})
        return unfinished

    # ------------------------------------------------------------------ stats
    def take_finished(self) -> Dict[int, Request]:
        """Drain and return retired requests."""
        out, self.finished = self.finished, {}
        return out

    def stats(self) -> Dict[str, Any]:
        s = self.bucketing.stats
        out = {
            "act_dtype": self.act_dtype or "f32",
            "prefill_traces": self.prefill_traces,
            "decode_traces": len(self.call_shapes["decode"]),
            "buckets": list(self.bucketing.buckets()),
            "bucket_hits": s.hits,
            "bucket_misses": s.misses,
            "bucket_hit_rate": s.hit_rate,
            "emitted_tokens": self.emitted_tokens,
            "engine_steps": self.engine_steps,
            "tokens_per_step": (self.emitted_tokens / self.engine_steps
                                if self.engine_steps else 0.0),
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
                for pool in (c.kp, c.vp):
                    feat = int(np.prod(pool.shape[2:]))
                    per_page += ps * feat * pool.element_size()
                    per_tok_fp += feat * fp_size
                for sc in (c.k_scale, c.v_scale):
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
        return out
