"""Serving: the batched engine core, prefill bucketing and the request
lifecycle."""
from .bucketing import BucketingPolicy, BucketStats  # noqa: F401
from .engine import Request, ServingEngine  # noqa: F401
from .lifecycle import (AdmissionRejected, IncompleteRun,  # noqa: F401
                        RequestState, TERMINAL_STATES)
