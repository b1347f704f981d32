"""CLAQ storage format: bit packing and QuantizedTensor."""
from .quantized import (QuantStripe, QuantizedTensor,  # noqa: F401
                        build_quantized_tensor)
