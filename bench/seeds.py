"""Sub-seeds of a run seed: one independent stream per named input."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed`` (any integer,
    negative or wider than 64 bits included)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)
