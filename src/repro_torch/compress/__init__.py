"""Compression types and post-training INT8 quantization."""
from repro_torch.compress.qtypes import (QuantizedLinear, linear_bytes,
                                         linear_kernel, out_features)
from repro_torch.compress.quantize import (QUANT_LINEAR_KEYS,
                                           quantize_linear,
                                           quantize_lm_params,
                                           symmetric_quantize)

__all__ = ["QuantizedLinear", "linear_bytes", "linear_kernel",
           "out_features", "QUANT_LINEAR_KEYS", "quantize_linear",
           "quantize_lm_params", "symmetric_quantize"]
