from repro_torch.quant.fixedpoint import (QuantSpec, compute_scale,
                                          dequantize, fake_quant, quantize)

__all__ = ["QuantSpec", "compute_scale", "dequantize", "fake_quant",
           "quantize"]
