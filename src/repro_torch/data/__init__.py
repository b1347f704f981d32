"""Synthetic calibration data (port of ``repro.data``)."""
from .pipeline import DataConfig, calibration_set, synth_batch  # noqa: F401
