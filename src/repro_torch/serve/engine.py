"""Batched serving engine, core path (port of ``repro.serve.engine``):
slot-based continuous batching over a fixed-size decode batch, with
bucketed prefill admission into free slots.

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

PyTorch runs eagerly, so there are no traces to count: ``prefill_traces``
is the number of distinct (batch, bucket) prefill shapes run, the
quantity the reference bounds by its trace count.

Port note — not accepted yet (each queued in ROADMAP.md): a device mesh
(``mesh``), self-speculative decoding (``draft_params``, ``spec``,
``draft_plan_bn``/``draft_plan_bk``), the paged KV cache (``kv_layout``,
``page_size``, ``kv_pages``, ``kv_dtype``, ``share_prefixes``), chunked
prefill (``chunked_prefill``),
numeric guards (``guards``), fault injection (``faults``), the queued
admission path with backpressure, priorities, deadlines and preemption
(``submit``, ``queue_depth``, ``on_pressure``, ``clock``), the overload
controller and cost model (``controller``, ``cost_model``), telemetry
(``telemetry``) and the contract checker (``verify_contracts``).  Passing
any of them raises ``TypeError``; a family other than dense raises
``NotImplementedError``.
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
from .bucketing import BucketingPolicy
from .lifecycle import (AdmissionRejected, IncompleteRun, RequestState,
                        TERMINAL_STATES)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    state: RequestState = RequestState.QUEUED

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


class ServingEngine:
    def __init__(self, params, cfg, n_slots: int = 8, max_len: int = 1024,
                 dtype=torch.float32, prepare: bool = True,
                 min_bucket: int = 16, bucketing: bool = True,
                 plan_bn: Optional[int] = None,
                 plan_bk: Optional[int] = None,
                 act_dtype: Optional[str] = None, device="cuda"):
        """``params``: a ``Transformer`` (``models.api.init_params`` or
        ``convert.from_numpy_tree``) on ``device``.  ``dtype`` is the KV
        cache's.  ``prepare`` compiles quantized kernels into plans (in
        place); ``plan_bn``/``plan_bk`` cap the plan's block sizes.
        ``act_dtype``: None/"f32", or "int8" (needs ``prepare``)."""
        if cfg.family == "encdec":
            raise NotImplementedError(
                "ServingEngine serves decoder-only families; encdec "
                "admission needs a frames input and a length-masked encoder")
        act_dtype = kops.normalize_act_dtype(act_dtype)
        if act_dtype is not None and not prepare:
            raise ValueError(
                "act_dtype='int8' needs ahead-of-time plans — drop "
                "prepare=False (the int8 path runs on prepared leaves only)")
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
        self.cache = api.make_cache(cfg, n_slots, max_len, dtype=dtype,
                                    device=self.device)
        self.free = list(range(n_slots))
        self.active: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.last_token = np.zeros((n_slots,), np.int64)
        self._uid = 0
        self.emitted_tokens = 0
        self.engine_steps = 0
        self.state_counts: collections.Counter = collections.Counter()

    @property
    def prefill_traces(self) -> int:
        """Distinct (batch, bucket) prefill shapes run so far."""
        return len(self.bucketing.stats.per_shape)

    # ------------------------------------------------------------------ admit
    @staticmethod
    def _fill(req: Request) -> int:
        """Slot-cache positions in use: the prompt plus one K/V write per
        decode step so far."""
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
        admission — look in ``finished``)."""
        if len(prompts) > len(self.free):
            raise AdmissionRejected(
                f"need {len(prompts)} free slots, have {len(self.free)}")
        reqs = [self._make_request(p, max_new_tokens, eos_id)
                for p in prompts]
        self._admit(reqs)
        return [r.uid for r in reqs]

    @torch.no_grad()
    def _admit(self, reqs: List[Request]) -> None:
        groups: Dict[int, List[int]] = {}
        for i, req in enumerate(reqs):
            groups.setdefault(self.bucketing.bucket_for(len(req.prompt)),
                              []).append(i)
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
            frag = api.make_cache(self.cfg, Bb, self.max_len,
                                  dtype=self._cache_dtype, device=self.device)
            with nn.activation_quant(self.act_dtype):
                logits, frag = api.prefill_step(
                    self.params, self.cfg,
                    {"tokens": torch.as_tensor(toks, device=self.device)},
                    frag,
                    logits_at=torch.as_tensor(lens - 1, device=self.device))
            firsts = logits.argmax(dim=-1).cpu().numpy()
            slots = [self.free.pop(0) for _ in idxs]
            self.cache = _masked_group_insert(
                self.cache, frag, slots, lens[:B].tolist(),
                self.bucketing.enabled)
            for r, i in enumerate(idxs):
                req = reqs[i]
                req.slot = slots[r]
                req.transition(RequestState.RUNNING)
                self.active[req.uid] = req
                self._append_token(req, int(firsts[r]))

    # -------------------------------------------------------------- lifecycle
    def _retire(self, req: Request,
                state: RequestState = RequestState.FINISHED) -> None:
        req.transition(state)
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

    # ------------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One batched decode over every slot; returns {uid: new token}.
        Requests whose slot cache is full retire TRUNCATED first."""
        for req in list(self.active.values()):
            if self._fill(req) >= self.max_len:
                self._retire(req, RequestState.TRUNCATED)
        if not self.active:
            return {}
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
        return {
            "act_dtype": self.act_dtype or "f32",
            "prefill_traces": self.prefill_traces,
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
