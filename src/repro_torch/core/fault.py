"""Fault model and threat surface (paper Sec. III), the counterpart of
``repro/core/fault.py``.

Transient soft errors flip the ``faulty_bits`` least-significant bits of
N_q-bit fixed-point tensors at per-bit rate ``fault_rate``, in stored
weights and in activations.  A ``FaultSpec`` plus an integer seed fully
determines the corruption, so candidate evaluations are reproducible.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_flatten, tree_unflatten
from repro_torch.kernels import ops
from repro_torch.quant.fixedpoint import QuantSpec

__all__ = ["FaultSpec", "FaultContext", "corrupt_tensor", "corrupt_tree",
           "layer_seed", "empirical_flip_rate", "PAPER_FAULT_SPEC"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault configuration (paper Sec. VI-B example config).

    ``fault_model`` is ``"flip"`` (paper Alg. 2), ``"stuck0"``/``"stuck1"``
    or ``"mbu"`` (bursts of ``mbu_width`` bits); see
    ``kernels/faultmodel.py``.
    """

    weight_fault_rate: float = 0.2
    act_fault_rate: float = 0.2
    faulty_bits: int = 4
    bits: int = 16
    enabled: bool = True
    fault_model: str = "flip"
    mbu_width: int = 2

    @property
    def quant_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.bits)

    def off(self) -> "FaultSpec":
        return dataclasses.replace(self, enabled=False)

    def with_rate(self, rate: float) -> "FaultSpec":
        return dataclasses.replace(self, weight_fault_rate=rate,
                                   act_fault_rate=rate)


# The paper's example configuration: 16-bit fixed point, 4 LSBs, FR=0.2.
PAPER_FAULT_SPEC = FaultSpec()


def layer_seed(base_seed: int, layer_idx: int, domain: int) -> int:
    """Deterministic per-(layer, domain) seed; domain 0=weights 1=acts."""
    return (base_seed * 1000003 + layer_idx * 8191 + domain * 131) & 0x7FFFFFFF


def corrupt_tensor(x: torch.Tensor, spec: FaultSpec, seed, *,
                   domain: str = "weight") -> torch.Tensor:
    """Quantize -> LSB-flip -> dequantize a float tensor."""
    rate = spec.weight_fault_rate if domain == "weight" else spec.act_fault_rate
    if not spec.enabled or rate <= 0.0:
        return x
    return ops.quant_bitflip(x, seed, rate, spec.faulty_bits, spec.quant_spec,
                             fault_model=spec.fault_model,
                             mbu_width=spec.mbu_width)


def corrupt_tree(tree, spec: FaultSpec, base_seed: int, *,
                 domain: str = "weight"):
    """Corrupt every float leaf of a tree with leaf-distinct seeds."""
    if not spec.enabled:
        return tree
    leaves, treedef = tree_flatten(tree)
    out = [corrupt_tensor(leaf, spec, layer_seed(base_seed, i, 0),
                          domain=domain)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           else leaf
           for i, leaf in enumerate(leaves)]
    return tree_unflatten(treedef, out)


@dataclasses.dataclass(frozen=True)
class FaultContext:
    """Binds a FaultSpec to a layer->device partition: a layer's rate is
    the spec's base rate times the fault scale of the device it maps to."""

    spec: FaultSpec
    partition: tuple[int, ...]
    device_fault_scale: tuple[float, ...]
    base_seed: int = 0

    def layer_rate(self, layer_idx: int, domain: str) -> float:
        base = (self.spec.weight_fault_rate if domain == "weight"
                else self.spec.act_fault_rate)
        if not self.spec.enabled:
            return 0.0
        d = self.partition[layer_idx]
        return float(base) * float(self.device_fault_scale[d])

    def corrupt(self, x: torch.Tensor, layer_idx: int, *,
                domain: str = "weight") -> torch.Tensor:
        rate = self.layer_rate(layer_idx, domain)
        if rate <= 0.0:
            return x
        seed = layer_seed(self.base_seed, layer_idx,
                          0 if domain == "weight" else 1)
        return ops.quant_bitflip(x, seed, rate, self.spec.faulty_bits,
                                 self.spec.quant_spec,
                                 fault_model=self.spec.fault_model,
                                 mbu_width=self.spec.mbu_width)


def empirical_flip_rate(q_clean: torch.Tensor, q_faulty: torch.Tensor,
                        faulty_bits: int) -> float:
    """Measured per-bit flip fraction over the vulnerable LSB range."""
    diff = torch.bitwise_xor(q_clean.to(torch.int32), q_faulty.to(torch.int32))
    flips = sum(int(((diff >> i) & 1).sum()) for i in range(faulty_bits))
    return flips / (q_clean.numel() * faulty_bits)
