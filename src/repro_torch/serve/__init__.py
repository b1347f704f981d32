"""Serving: the batched engine, prefill bucketing, the request lifecycle,
self-speculative decoding and the paged KV cache's page bookkeeping."""
from .bucketing import BucketingPolicy, BucketStats  # noqa: F401
from .engine import Request, ServingEngine  # noqa: F401
from .lifecycle import (AdmissionRejected, IncompleteRun,  # noqa: F401
                        RequestState, TERMINAL_STATES)
from .paging import PageAllocator, PoolExhausted, PrefixRegistry  # noqa: F401
from .speculative import SpecConfig  # noqa: F401
