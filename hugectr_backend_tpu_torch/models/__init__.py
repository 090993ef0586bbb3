from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params
from hugectr_backend_tpu_torch.models.quant_dense import (
    QuantDense,
    quantize_dense_params,
    quantize_model_params,
    quantize_weight,
)

__all__ = [
    "DLRM",
    "load_flax_dlrm_params",
    "QuantDense",
    "quantize_dense_params",
    "quantize_model_params",
    "quantize_weight",
]
