from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import bitflip, fault_matmul, quant_bitflip

__all__ = ["ops", "ref", "bitflip", "fault_matmul", "quant_bitflip"]
