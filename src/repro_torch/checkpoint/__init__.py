"""Checkpoints in the reference's format (port of ``repro.checkpoint``)."""
from .manager import CheckpointCorrupt, CheckpointManager  # noqa: F401
