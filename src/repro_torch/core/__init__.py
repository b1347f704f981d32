"""CLAQ core (port of ``repro.core``): the storage format, the quantizer
(K-Means codebooks, Outlier Order, Adaptive Precision, Outlier Reservation,
GPTQ compensation) and its orchestration."""
from .policy import APConfig, CLAQConfig, ORConfig, draft_config  # noqa: F401
from .claq import (  # noqa: F401
    MatrixPlan,
    QuantStats,
    plan_matrix,
    quantize_matrix,
    quantize_model,
    default_quantize_predicate,
)
from .quantized import (QuantStripe, QuantizedTensor,  # noqa: F401
                        build_quantized_tensor)
from .kmeans import kmeans_1d, kmeans_columns, dequantize_codes  # noqa: F401
from .outlier import (  # noqa: F401
    outlier_ratio,
    outlier_order,
    top_fraction_mask,
    topk_per_column_mask,
    layer_outlier_ratio,
)
from .gptq import (  # noqa: F401
    HessianState,
    init_hessian,
    accumulate_hessian,
    finalize_hessian,
    prepare_hinv_cholesky,
    gptq_quantize_matrix,
    proxy_loss,
)
