"""Compression types and post-training quantization, real and simulated."""
from repro_torch.compress.qtypes import (QuantizedLinear, linear_bytes,
                                         linear_kernel, out_features)
from repro_torch.compress.quantize import (QUANT_LINEAR_KEYS, fake_quant,
                                           fake_quant_tree,
                                           quantize_linear,
                                           quantize_lm_params,
                                           symmetric_quantize)

__all__ = ["QuantizedLinear", "linear_bytes", "linear_kernel",
           "out_features", "QUANT_LINEAR_KEYS", "fake_quant",
           "fake_quant_tree", "quantize_linear",
           "quantize_lm_params", "symmetric_quantize"]
