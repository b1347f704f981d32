"""Prefill length-bucketing policy for the serving engine.

Every distinct prefill operand shape costs one XLA trace+compile, so an
engine that prefills prompts at their exact length pays one compile per
distinct prompt length — fatal at serving scale.  The policy here rounds
each prompt length up to a power-of-2 bucket in ``[min_bucket, max_len]``
(the final bucket is clamped to ``max_len`` even when it is not a
power-of-2 multiple), bounding the number of distinct prefill shapes —
and therefore traces — at ``ceil(log2(max_len / min_bucket)) + 1``.

The policy also keeps compile-cache statistics mirroring jit's cache key:
the first admission at a given ``(batch, bucket)`` shape is a miss (a
fresh trace), every later admission at that shape is a hit.  The engine's
``prefill_traces`` counter (a Python side effect inside the jitted
function, executed once per trace) is the ground truth these stats are
checked against in tests/test_serving.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


@dataclasses.dataclass
class BucketStats:
    """Compile-cache accounting: one miss per distinct (batch, bucket)."""
    hits: int = 0
    misses: int = 0
    per_shape: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.total if self.total else 0.0


class BucketingPolicy:
    """Power-of-2 length buckets between ``min_bucket`` and ``max_len``.

    ``enabled=False`` degrades to the identity policy (bucket == length):
    admission still groups equal-length prompts for batched prefill, but
    every distinct length is its own compile.  The engine disables padding
    for recurrent families (rwkv / hybrid) this way, since a padded
    suffix would flow into their state.
    """

    def __init__(self, min_bucket: int = 16, max_len: int = 1024,
                 enabled: bool = True):
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        self.min_bucket = min(min_bucket, max_len)
        self.max_len = max_len
        self.enabled = enabled
        sizes = []
        b = self.min_bucket
        while b < max_len:
            sizes.append(b)
            b *= 2
        sizes.append(max_len)
        self._buckets = tuple(sizes)
        self.stats = BucketStats()

    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def max_traces(self) -> int:
        """Upper bound on distinct batch-1 prefill shapes (== bucket count,
        == ceil(log2(max_len / min_bucket)) + 1)."""
        return (int(math.ceil(math.log2(self.max_len / self.min_bucket))) + 1
                if self.max_len > self.min_bucket else 1)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding a prompt of length n (identity when
        disabled).  Raises if the prompt cannot fit any bucket."""
        if not 1 <= n <= self.max_len:
            raise ValueError(
                f"prompt length {n} outside [1, max_len={self.max_len}]")
        if not self.enabled:
            return n
        for b in self._buckets:
            if n <= b:
                return b
        return self.max_len  # unreachable: last bucket is max_len

    def record(self, batch: int, bucket: int) -> bool:
        """Account one prefill at shape (batch, bucket); True = the shape
        was seen before, i.e. this admission hits the compile cache."""
        key = (batch, bucket)
        hit = key in self.stats.per_shape
        self.stats.per_shape[key] = self.stats.per_shape.get(key, 0) + 1
        if hit:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        return hit
