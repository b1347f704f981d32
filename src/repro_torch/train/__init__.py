"""The train step (port of ``repro.train``)."""
from .step import make_train_step  # noqa: F401
