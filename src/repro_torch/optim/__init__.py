"""AdamW, schedules and clipping (port of ``repro.optim``)."""
from .adamw import (  # noqa: F401
    OptimConfig, OptState, init_opt_state, apply_updates, schedule,
    global_norm, clip_by_global_norm, compress_int8, decompress_int8,
    compressed_psum,
)
