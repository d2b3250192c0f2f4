"""The paper's evaluation CNNs (AlexNet, SqueezeNet, ResNet18), the
counterpart of ``repro/models/cnn.py``.

Layouts are the reference's: activations NHWC, conv weights HWIO, fc
weights (K, N), so the fault hash indexes the same elements.  Tensors are
corrupted in that layout and only then viewed as NCHW/OIHW for
``F.conv2d`` (the NHWC tensor viewed as NCHW is channels-last, so the
permute copies nothing).  XLA's ``"SAME"`` padding is reproduced exactly:
at stride 2 with an even input it pads (0, 1), not (1, 1).

Row axis: the reference adds the population axis with ``vmap``; here every
activation carries a leading row axis ``[R, B, H, W, C]`` and rates are
``[R]`` tensors (or None).  Each row's conv weights may differ, so the conv
runs one ``F.conv2d`` per row.  A loop rather than a grouped conv: it
keeps each row's computation the very call a one-row dispatch makes, so
row batching and chunking never change a value (the staged engine's
chunks of fresh prefixes against the whole-forward path's single rows,
bitwise).  The global average pool loops over rows for the same reason.

Seed contract (``repro/models/cnn.py:100-136``): unit ``i`` uses
``seed + 7919 * i``, its input activations ``+ 1``, and weight leaf ``j``
``+ 977 * j`` over the SORTED-key flatten order of the unit's params.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.costmodel import LayerInfo
from repro_torch.models.layers import (QTensor, dequantize_params,
                                       fault_dense, maybe_corrupt,
                                       quantize_leaf)

__all__ = ["AlexNet", "SqueezeNet", "ResNet18", "CNN_MODELS", "FAULT_BITS",
           "FAULTY_BITS", "build_weight_fault_tables", "quantize_unit_params"]

# INT8-class fixed point with 4 vulnerable LSBs, as the reference CNNs.
FAULT_BITS = 8
FAULTY_BITS = 4


def _with_prior(infos):
    """Analytic sensitivity prior (earlier layers propagate corruption
    further); replaced by profiled values when a layer sweep is run."""
    n = len(infos)
    out = []
    for i, li in enumerate(infos):
        x = i / max(n - 1, 1)
        out.append(dataclasses.replace(
            li, sensitivity=0.002 * (1.35 - x + 0.25 * x ** 4)))
    return out


# --------------------------------------------------------------------------
# primitives on row-batched NHWC tensors
# --------------------------------------------------------------------------
def _conv_init(gen, kh, kw, cin, cout):
    scale = math.sqrt(2.0 / (kh * kw * cin))
    return {"w": torch.randn(kh, kw, cin, cout, generator=gen) * scale,
            "b": torch.zeros(cout)}


def _dense_init(gen, din, dout):
    scale = math.sqrt(2.0 / din)
    return {"w": torch.randn(din, dout, generator=gen) * scale,
            "b": torch.zeros(dout)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _add_bias(y: torch.Tensor, b: torch.Tensor, per_row_ndim: int):
    """``y + b`` where ``b`` is shared ``[C]`` or per row ``[R, C]``."""
    if b.ndim == per_row_ndim:
        b = b.reshape(b.shape[0], *([1] * (y.ndim - 2)), b.shape[-1])
    return y + b


def _conv(p, x, stride=1):
    """NHWC x ``[R, B, H, W, Cin]`` with HWIO weights, shared or ``[R, ...]``."""
    w = p["w"]
    kh, kw = w.shape[-4], w.shape[-3]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    outs = []
    for r in range(x.shape[0]):
        xr = x[r].permute(0, 3, 1, 2)
        if any(ph + pw):
            xr = F.pad(xr, (pw[0], pw[1], ph[0], ph[1]))
        wr = (w[r] if w.ndim == 5 else w).permute(3, 2, 0, 1)
        outs.append(F.conv2d(xr, wr, stride=stride).permute(0, 2, 3, 1))
    y = outs[0].unsqueeze(0) if len(outs) == 1 else torch.stack(outs)
    return _add_bias(y, p["b"], 2)


def _maxpool(x, k=2, s=2):
    R, B, H, W, C = x.shape
    y = F.max_pool2d(x.reshape(R * B, H, W, C).permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).reshape(R, B, *y.shape[2:], C)


def _gap(x):
    """Global average pool, one reduction per row like the conv loop: the
    reduction's launch shape then never depends on the row count."""
    return torch.stack([x[r].mean(dim=(1, 2)) for r in range(x.shape[0])])


def _dense(p, x):
    return _add_bias(fault_dense(x, p["w"]), p["b"], 2)


def _row_weight(w, rate):
    """A shared float weight expanded to the rows its ``[R]`` rate needs."""
    if isinstance(w, QTensor):
        return w
    return w.expand(rate.shape[0], *w.shape)


def _corrupt_unit(p, x, wr, ar, seed):
    """The paper's fault model on one unit: every ndim>1 weight leaf at
    ``seed + 977 * j``, the input activations at ``seed + 1``.  ``wr``
    None skips weight corruption (tables pass pre-corrupted weights),
    ``ar`` None skips the activations."""
    if wr is not None:
        leaves, treedef = tree_flatten(p)
        leaves = [maybe_corrupt(_row_weight(w, wr), wr, seed + 977 * i,
                                bits=FAULT_BITS, faulty_bits=FAULTY_BITS)
                  if w.ndim > 1 else w
                  for i, w in enumerate(leaves)]
        p = tree_unflatten(treedef, leaves)
    else:
        p = dequantize_params(p)
    if ar is not None:
        x = maybe_corrupt(x, ar, seed + 1, bits=FAULT_BITS,
                          faulty_bits=FAULTY_BITS)
    return p, x


def build_weight_fault_tables(params, w_rates_by_device, base_seed: int = 0):
    """Pre-corrupt every unit's weights once per (unit, device): leaves
    stacked ``[D, ...]`` (row d = the weights as corrupted on device d,
    biases replicated), bitwise what the inline path computes at rate
    ``w_rates_by_device[d]``."""
    out = []
    for i, unit in enumerate(params):
        leaves, treedef = tree_flatten(unit)
        dev = leaves[0].device
        rates = torch.as_tensor(np.asarray(w_rates_by_device, np.float32),
                                device=dev)
        D = rates.shape[0]
        stacked = [maybe_corrupt(w.expand(D, *w.shape), rates,
                                 base_seed + 7919 * i + 977 * j,
                                 bits=FAULT_BITS, faulty_bits=FAULTY_BITS)
                   if w.ndim > 1 else w.expand(D, *w.shape)
                   for j, w in enumerate(leaves)]
        out.append(tree_unflatten(treedef, stacked))
    return out


def quantize_unit_params(params, bits: int = FAULT_BITS):
    """One resident integer copy of every corruptible (ndim>1) weight for
    the kernel backend; 2-D leaves (the fc weights) are matmul-marked so
    their flips happen inside ``fault_matmul``.  Biases stay floats."""
    return [tree_map(lambda w: quantize_leaf(w, bits, matmul=(w.ndim == 2))
                     if w.ndim > 1 else w, unit) for unit in params]


def _to_device(params, device):
    return tree_map(lambda t: t.to(device), params)


class _StepModel:
    """Whole-model forward derived from the per-unit ``step``.

    ``step(i, p_i, x, wr, ar, seed)`` runs unit ``i`` on row-batched ``x``
    with ``[R]`` rates (either may be None) and the unit's seed;
    ``segment`` composes a run of units (rates ``[R, len]``, seeds from
    the ABSOLUTE unit index) and ``apply`` is the whole-model segment.
    """

    n_units: int = 0

    @classmethod
    def segment(cls, start, params, x, w_rates=None, a_rates=None, seed=0):
        for k in range(len(params)):
            if w_rates is None and a_rates is None:
                x = cls.step(start + k, params[k], x)
            else:
                x = cls.step(start + k, params[k], x,
                             None if w_rates is None else w_rates[:, k],
                             None if a_rates is None else a_rates[:, k],
                             seed + 7919 * (start + k))
        return x

    @classmethod
    def apply(cls, params, x, w_rates=None, a_rates=None, seed=0):
        """Logits for NHWC images ``x [B, H, W, C]``.  Rates ``[L]`` (or
        None) give ``[B, classes]``; rates ``[R, L]`` run R candidates
        over the same images and give ``[R, B, classes]``."""
        rates = w_rates if w_rates is not None else a_rates
        single = rates is None or rates.ndim == 1
        wr = None if w_rates is None else w_rates.reshape(-1, cls.n_units)
        ar = None if a_rates is None else a_rates.reshape(-1, cls.n_units)
        R = 1 if rates is None else (wr if wr is not None else ar).shape[0]
        out = cls.segment(0, params, x.expand(R, *x.shape), wr, ar, seed)
        return out[0] if single else out


# ==========================================================================
# AlexNet (5 conv + 3 fc = 8 partitionable units)
# ==========================================================================
class AlexNet(_StepModel):
    n_units = 8

    @staticmethod
    def channels(width: float = 1.0):
        c = lambda v: max(8, int(v * width))
        return [c(64), c(192), c(384), c(256), c(256)], [c(1024), c(1024)]

    @staticmethod
    def init(seed: int = 0, num_classes=16, width: float = 1.0, img: int = 32,
             device="cuda"):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        convs, fcs = AlexNet.channels(width)
        p, cin = [], 3
        for cout in convs:
            p.append(_conv_init(gen, 3, 3, cin, cout))
            cin = cout
        feat = (img // 8) ** 2 * convs[4]      # three maxpools of 2
        p.append(_dense_init(gen, feat, fcs[0]))
        p.append(_dense_init(gen, fcs[0], fcs[1]))
        p.append(_dense_init(gen, fcs[1], num_classes))
        return _to_device(p, dev)

    @staticmethod
    def step(i, p, x, wr=None, ar=None, seed=0):
        p, x = _corrupt_unit(p, x, wr, ar, seed)
        if i < 5:
            x = F.relu(_conv(p, x))
            if i in (0, 1, 4):
                x = _maxpool(x)
            if i == 4:                          # NHWC flatten, as the reference
                x = x.reshape(x.shape[0], x.shape[1], -1)
            return x
        x = _dense(p, x)
        return F.relu(x) if i < 7 else x

    @staticmethod
    def layer_infos(num_classes=16, width: float = 1.0, img: int = 32):
        convs, fcs = AlexNet.channels(width)
        infos = []
        cin, hw = 3, img
        pools_after = {0, 1, 4}
        for i, cout in enumerate(convs):
            macs = 9 * cin * cout * hw * hw
            infos.append(LayerInfo(
                name=f"conv{i}", kind="conv", macs=macs,
                weight_bytes=9 * cin * cout * 2,
                act_in_bytes=hw * hw * cin * 2,
                act_out_bytes=(hw // (2 if i in pools_after else 1)) ** 2 * cout * 2,
                params=9 * cin * cout))
            if i in pools_after:
                hw //= 2
            cin = cout
        feat = hw * hw * convs[4]
        dims = [(feat, fcs[0]), (fcs[0], fcs[1]), (fcs[1], num_classes)]
        for j, (a, b) in enumerate(dims):
            infos.append(LayerInfo(
                name=f"fc{j}", kind="fc", macs=a * b, weight_bytes=a * b * 2,
                act_in_bytes=a * 2, act_out_bytes=b * 2, params=a * b))
        return _with_prior(infos)


# ==========================================================================
# SqueezeNet (conv1 + 8 fire modules + conv10 = 10 units)
# ==========================================================================
class SqueezeNet(_StepModel):
    n_units = 10

    @staticmethod
    def fire_specs(width: float = 1.0):
        c = lambda v: max(4, int(v * width))
        return [(c(16), c(64)), (c(16), c(64)), (c(32), c(128)),
                (c(32), c(128)), (c(48), c(192)), (c(48), c(192)),
                (c(64), c(256)), (c(64), c(256))]

    @staticmethod
    def init(seed: int = 0, num_classes=16, width: float = 1.0, img: int = 32,
             device="cuda"):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        c0 = max(8, int(64 * width))
        p = [{"conv": _conv_init(gen, 3, 3, 3, c0)}]
        cin = c0
        for s, e in SqueezeNet.fire_specs(width):
            p.append({"squeeze": _conv_init(gen, 1, 1, cin, s),
                      "e1": _conv_init(gen, 1, 1, s, e),
                      "e3": _conv_init(gen, 3, 3, s, e)})
            cin = 2 * e
        p.append({"conv": _conv_init(gen, 1, 1, cin, num_classes)})
        return _to_device(p, dev)

    @staticmethod
    def step(i, p, x, wr=None, ar=None, seed=0):
        p, x = _corrupt_unit(p, x, wr, ar, seed)
        if i == 0:
            return _maxpool(F.relu(_conv(p["conv"], x)))
        if i == 9:
            return _gap(_conv(p["conv"], x))
        s = F.relu(_conv(p["squeeze"], x))
        e1 = F.relu(_conv(p["e1"], s))
        e3 = F.relu(_conv(p["e3"], s))
        x = torch.cat([e1, e3], dim=-1)
        return _maxpool(x) if i - 1 in (1, 3) else x

    @staticmethod
    def layer_infos(num_classes=16, width: float = 1.0, img: int = 32):
        specs = SqueezeNet.fire_specs(width)
        c0 = max(8, int(64 * width))
        infos = []
        hw = img
        infos.append(LayerInfo("conv1", "conv", 9 * 3 * c0 * hw * hw,
                               9 * 3 * c0 * 2, hw * hw * 3 * 2,
                               (hw // 2) ** 2 * c0 * 2, 9 * 3 * c0))
        hw //= 2
        cin = c0
        pools_after = {1, 3}
        for i, (s, e) in enumerate(specs):
            macs = hw * hw * (cin * s + s * e + 9 * s * e)
            wparams = cin * s + s * e + 9 * s * e
            out_hw = hw // (2 if i in pools_after else 1)
            infos.append(LayerInfo(
                f"fire{i}", "fire", macs, wparams * 2,
                hw * hw * cin * 2, out_hw ** 2 * 2 * e * 2, wparams))
            if i in pools_after:
                hw //= 2
            cin = 2 * e
        infos.append(LayerInfo("conv10", "conv", cin * num_classes * hw * hw,
                               cin * num_classes * 2, hw * hw * cin * 2,
                               num_classes * 2, cin * num_classes))
        return _with_prior(infos)


# ==========================================================================
# ResNet18 (stem + 8 basic blocks + fc = 10 units)
# ==========================================================================
class ResNet18(_StepModel):
    n_units = 10

    @staticmethod
    def stage_channels(width: float = 1.0):
        c = lambda v: max(8, int(v * width))
        return [c(64), c(128), c(256), c(512)]

    @staticmethod
    def init(seed: int = 0, num_classes=16, width: float = 1.0, img: int = 32,
             device="cuda"):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        chs = ResNet18.stage_channels(width)
        p = [{"conv": _conv_init(gen, 3, 3, 3, chs[0])}]
        cin = chs[0]
        for stage, cout in enumerate(chs):
            for blk in range(2):
                stride = 2 if (stage > 0 and blk == 0) else 1
                bp = {"c1": _conv_init(gen, 3, 3, cin, cout),
                      "c2": _conv_init(gen, 3, 3, cout, cout)}
                if stride != 1 or cin != cout:
                    bp["proj"] = _conv_init(gen, 1, 1, cin, cout)
                p.append(bp)
                cin = cout
        p.append(_dense_init(gen, chs[3], num_classes))
        return _to_device(p, dev)

    @staticmethod
    def step(i, p, x, wr=None, ar=None, seed=0):
        fp, x = _corrupt_unit(p, x, wr, ar, seed)
        if i == 0:
            return F.relu(_conv(fp["conv"], x))
        if i == 9:
            return _dense(fp, x)
        stage, blk = (i - 1) // 2, (i - 1) % 2
        stride = 2 if (stage > 0 and blk == 0) else 1
        h = F.relu(_conv(fp["c1"], x, stride=stride))
        h = _conv(fp["c2"], h)
        sc = _conv(fp["proj"], x, stride=stride) if "proj" in fp else x
        x = F.relu(h + sc)
        return _gap(x) if i == 8 else x

    @staticmethod
    def layer_infos(num_classes=16, width: float = 1.0, img: int = 32):
        chs = ResNet18.stage_channels(width)
        infos = []
        hw = img
        infos.append(LayerInfo("stem", "conv", 9 * 3 * chs[0] * hw * hw,
                               9 * 3 * chs[0] * 2, hw * hw * 3 * 2,
                               hw * hw * chs[0] * 2, 9 * 3 * chs[0]))
        cin = chs[0]
        for stage, cout in enumerate(chs):
            for blk in range(2):
                stride = 2 if (stage > 0 and blk == 0) else 1
                out_hw = hw // stride
                macs = (9 * cin * cout * out_hw ** 2
                        + 9 * cout * cout * out_hw ** 2)
                wp = 9 * cin * cout + 9 * cout * cout
                if stride != 1 or cin != cout:
                    macs += cin * cout * out_hw ** 2
                    wp += cin * cout
                infos.append(LayerInfo(
                    f"s{stage}b{blk}", "resblock", macs, wp * 2,
                    hw * hw * cin * 2, out_hw ** 2 * cout * 2, wp))
                hw = out_hw
                cin = cout
        infos.append(LayerInfo("fc", "fc", chs[3] * num_classes,
                               chs[3] * num_classes * 2, chs[3] * 2,
                               num_classes * 2, chs[3] * num_classes))
        return _with_prior(infos)


CNN_MODELS = {"alexnet": AlexNet, "squeezenet": SqueezeNet,
              "resnet18": ResNet18}
