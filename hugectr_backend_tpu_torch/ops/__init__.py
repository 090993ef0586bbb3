from hugectr_backend_tpu_torch.ops.quantize import (
    dequantize_rows,
    quantize_rows_fp8,
    quantize_rows_int8,
)

__all__ = [
    "dequantize_rows",
    "quantize_rows_fp8",
    "quantize_rows_int8",
]
