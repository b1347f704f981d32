"""Serving: the batched engine, prefill bucketing, the request lifecycle,
fault injection, chunked prefill, the SLO admission controller,
self-speculative decoding, the paged KV cache's page bookkeeping,
telemetry and trace replay."""
from .admission import (AdmissionController,  # noqa: F401
                        ControllerDecision, SLOConfig, StepCostModel)
from .bucketing import BucketingPolicy, BucketStats  # noqa: F401
from .chunked_prefill import (ChunkedPrefillConfig,  # noqa: F401
                              PrefillGroup)
from .engine import Request, ServingEngine  # noqa: F401
from .faults import FaultInjector, nonfinite_rows  # noqa: F401
from .lifecycle import (AdmissionQueue, AdmissionRejected,  # noqa: F401
                        DeadlineExceeded, EngineFault, IncompleteRun,
                        RequestState, RetryPolicy, StepClock,
                        TERMINAL_STATES)
from .paging import PageAllocator, PoolExhausted, PrefixRegistry  # noqa: F401
from .replay import (Arrival, Replayer, build_report,  # noqa: F401
                     load_trace, save_trace, synthesize_trace,
                     validate_report)
from .speculative import SpecConfig  # noqa: F401
from .telemetry import (Histogram, MetricsRegistry,  # noqa: F401
                        Telemetry, perfetto_trace, registry_from_stats,
                        write_perfetto)
