"""The one traffic generator: a closed loop of clients whose requests come
from a traffic file's parameters.

A traffic file (``bench/traffic/<name>.json``) holds:

  * ``source``: the public trace or paper its lengths are taken from;
  * ``clients``: callers that each wait for a reply before sending again.
    More clients than ``slots`` keep requests waiting in the engine's
    admission queue, so a request's first token waits for a free slot;
  * ``slots`` and ``max_len``: the engine's batch slots and cache length;
  * ``prompt_tokens`` and ``output_tokens``: ``{"median", "sigma", "min",
    "max"}``, each length log-normal about ``median`` with log-scale
    ``sigma``, rounded and clipped to ``[min, max]``.  Outputs start at 3
    tokens or more, and the longest prompt and output together fit
    ``max_len``;
  * ``requests_per_client``: the length of each client's sequence;
  * ``shape_seed``: the seed of the lengths.  Every run seed serves the
    same set of lengths, so two seeds do the same work; the run seed
    decides which client gets which sequence, the token ids and the
    weights;
  * ``warmup``: ``prompt_tokens`` and ``output_tokens`` of the one request
    that runs the model once through prefill and decode before anything
    is timed.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import seeds


@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int              # place in the client's sequence
    prompt: List[int]
    max_new: int


@dataclasses.dataclass(frozen=True)
class Traffic:
    clients: List[List[Request]]     # each client's requests, in order
    warmup: Request
    slots: int
    max_len: int


def _draw(rng: np.random.Generator, dist: dict, shape) -> np.ndarray:
    x = rng.lognormal(np.log(float(dist["median"])), float(dist["sigma"]),
                      shape)
    return np.clip(np.rint(x), int(dist["min"]),
                   int(dist["max"])).astype(np.int64)


def lengths(spec: dict) -> np.ndarray:
    """(clients, requests_per_client, 2) prompt and output lengths, drawn
    from ``spec``'s distributions with its ``shape_seed``."""
    rng = np.random.default_rng(int(spec["shape_seed"]))
    shape = (int(spec["clients"]), int(spec["requests_per_client"]))
    p, o = spec["prompt_tokens"], spec["output_tokens"]
    (plo, phi), (olo, ohi) = (p["min"], p["max"]), (o["min"], o["max"])
    if phi + ohi > spec["max_len"]:
        raise ValueError("the longest request does not fit max_len")
    if olo < 3:
        # a request must outlive the step that admits it (its prefill's
        # token and that step's decode token), or its slot goes unseen
        raise ValueError("output_tokens must start at 3 or more")
    if plo < 1:
        raise ValueError("prompt_tokens must start at 1 or more")
    return np.stack([_draw(rng, p, shape), _draw(rng, o, shape)], axis=-1)


def generate(spec: dict, seed: int, vocab: int) -> Traffic:
    """The requests of one run: ``spec``'s lengths, their sequences dealt
    to the clients in an order drawn from ``seed``, token ids uniform over
    ``vocab`` from ``seed``."""
    rng = np.random.default_rng(seeds.sub_seed(seed, "traffic"))
    lens = lengths(spec)
    order = rng.permutation(lens.shape[0])
    clients = []
    for c, src in enumerate(order):
        reqs = []
        for i, (p, o) in enumerate(lens[src]):
            toks = rng.integers(0, vocab, int(p)).tolist()
            reqs.append(Request(c, i, toks, int(o)))
        clients.append(reqs)
    w = spec["warmup"]
    warm = Request(-1, 0, rng.integers(0, vocab, int(w["prompt_tokens"]))
                   .tolist(), int(w["output_tokens"]))
    return Traffic(clients, warm, int(spec["slots"]), int(spec["max_len"]))
