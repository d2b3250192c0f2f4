from repro_torch.quant.fixedpoint import (QuantSpec, compute_scale,
                                          dequantize, dequantize_tree,
                                          fake_quant, quantize, quantize_tree)

__all__ = ["QuantSpec", "compute_scale", "dequantize", "fake_quant",
           "quantize", "quantize_tree", "dequantize_tree"]
