"""Architecture configs (published shapes) + smoke variants + shape cells."""
from .base import ModelConfig, ShapeCell, SHAPES, SHAPES_BY_NAME, cell_applicable, reduce_for_smoke  # noqa: F401
from .registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
