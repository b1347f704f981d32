"""Synthetic corpus and calibration data (port of ``repro.data``)."""
from .pipeline import (DataConfig, SyntheticCorpus,  # noqa: F401
                       calibration_set, synth_batch)
