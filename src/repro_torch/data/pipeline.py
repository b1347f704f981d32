"""Synthetic-corpus data (port of ``repro.data.pipeline``): a hashed
first-order Markov process mixed with Zipf unigrams, a pure function of
(seed, step), so restarts and re-shards never replay or skip a batch.

The successor hash is uint32 arithmetic in the reference.  torch has no
full uint32 type, so it runs in int64 masked to 32 bits, with products
split so no intermediate passes 2**63: it is bit-exact with the
reference.  The random draws come from a ``torch.Generator`` seeded from
(seed, step) and cannot equal ``jax.random``'s; tests that compare the
packages feed both the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    # Markov structure: next ~ mix of `branch` hashed successors of cur
    branch: int = 4
    struct_prob: float = 0.85     # P(follow structure) vs unigram noise
    name: str = "c4like"          # c4like | wikilike (different hash salt)


_FAMILY_SALT = {"c4like": 0x9E3779B1, "wikilike": 0x85EBCA77}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a 32-bit constant
    c, without an int64 product past 2**48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_successors(tok: torch.Tensor, vocab: int, branch: int,
                     salt: int) -> torch.Tensor:
    """Deterministic per-token successor set: (..., branch) int64."""
    t = tok.long() & _M32                     # the uint32 view of the token
    ks = torch.arange(1, branch + 1, dtype=torch.int64, device=tok.device)
    h = (_mul32(t[..., None], salt) + _mul32(ks, 0xC2B2AE35)) & _M32
    h = h ^ (h >> 13)
    h = _mul32(h, 0x27D4EB2F)
    return h % vocab


def _zipf(gen: torch.Generator, n: int, vocab: int) -> torch.Tensor:
    """Zipf-ish unigram draws: u**3 * vocab with u uniform in [1e-6, 1)."""
    u = torch.rand(n, generator=gen) * (1.0 - 1e-6) + 1e-6
    return (u.pow(3.0) * vocab).to(torch.int64) % vocab


def synth_batch(cfg: DataConfig, step: int) -> torch.Tensor:
    """(batch, seq_len) int64 tokens on the CPU, a pure function of
    (cfg.seed, step)."""
    salt = _FAMILY_SALT.get(cfg.name, 0x9E3779B1)
    gen = torch.Generator().manual_seed(((cfg.seed & _M32) << 32)
                                        | (step & _M32))
    cur = _zipf(gen, cfg.batch, cfg.vocab)
    toks = []
    for _ in range(cfg.seq_len):
        toks.append(cur)
        succ = _hash_successors(cur, cfg.vocab, cfg.branch, salt)
        pick = torch.randint(0, cfg.branch, (cfg.batch, 1), generator=gen)
        structured = torch.gather(succ, 1, pick)[:, 0]
        noise = _zipf(gen, cfg.batch, cfg.vocab)
        use_struct = torch.rand(cfg.batch, generator=gen) < cfg.struct_prob
        cur = torch.where(use_struct, structured, noise)
    return torch.stack(toks, dim=1)


class SyntheticCorpus:
    """Step-indexed corpus with optional host sharding: shard ``shard`` of
    ``num_shards`` gets its contiguous slice of each global batch."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards

    def batch_at(self, step: int) -> torch.Tensor:
        full = synth_batch(self.cfg, int(step))
        if self.num_shards == 1:
            return full
        per = self.cfg.batch // self.num_shards
        return full[self.shard * per:(self.shard + 1) * per]

    def iterate(self, start_step: int = 0) -> Iterator[torch.Tensor]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def calibration_set(vocab: int, n_segments: int = 128, seq_len: int = 2048,
                    seed: int = 1234, name: str = "c4like") -> torch.Tensor:
    """The paper's calibration protocol: ``n_segments`` random
    ``seq_len``-token segments (paper §F), from the synthetic corpus."""
    cfg = DataConfig(vocab=vocab, seq_len=seq_len, batch=n_segments,
                     seed=seed, name=name)
    return synth_batch(cfg, 0)
