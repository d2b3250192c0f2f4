"""ResNet18 (He et al. 2016, arXiv:1512.03385) in plain PyTorch, float32,
under the configuration's fault model, and the benchmark's weights and
calibration images made from the seed.

The network is the CIFAR ResNet18 the configuration states: a 3x3 stem
convolution at stride 1 (no max pool), four stages of two basic blocks at
the published widths 64-128-256-512 (3x3 convolutions, a 1x1 projection
where the shape changes, stride 2 at the first block of stages 2-4), a
global average pool and one dense layer to the classes.  Batch norm is
folded into each convolution's weights and bias, as an inference
deployment runs it.  Convolutions pad as "SAME" does: at stride 2 on an
even input, 0 before and 1 after.

Ten units, each a partitionable layer: the stem, the eight blocks, the
dense head.  A unit mapped to device ``d`` runs with its input activations
and its weights (every leaf of two or more dimensions; biases stay exact)
corrupted at that device's rates (``fault.py``), in the fixed-point format
the configuration states.  Activations are NHWC and convolution weights
HWIO, the layout in which the fault model indexes elements.

ΔAcc of a mapping is ``max(0, clean - faulty)``: top-1 accuracies against
labels that are the clean model's own argmax (the rate-0 pass: every
weight and activation quantized, nothing flipped).

``precision="tf32"`` is the control: the same arithmetic with TF32 allowed
in cuDNN's convolutions and in matmuls.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import cost, fault

N_UNITS = 10


# ---------------------------------------------------------------- shapes
def _blocks(chs):
    """(cin, cout, stride, has_proj) of the eight blocks."""
    out, cin = [], chs[0]
    for stage, cout in enumerate(chs):
        for blk in range(2):
            stride = 2 if (stage > 0 and blk == 0) else 1
            out.append((cin, cout, stride, stride != 1 or cin != cout))
            cin = cout
    return out


def leaf_shapes(conf) -> list[dict]:
    """Each unit's parameter tree as ``{path: shape}`` (sorted-key order)."""
    chs, nc = conf["stage_channels"], conf["num_classes"]
    units = [{"conv.b": (chs[0],), "conv.w": (3, 3, 3, chs[0])}]
    for cin, cout, _, proj in _blocks(chs):
        u = {"c1.b": (cout,), "c1.w": (3, 3, cin, cout),
             "c2.b": (cout,), "c2.w": (3, 3, cout, cout)}
        if proj:
            u.update({"proj.b": (cout,), "proj.w": (1, 1, cin, cout)})
        units.append(u)
    units.append({"b": (nc,), "w": (chs[3], nc)})
    return units


def layers(conf) -> list[tuple]:
    """Per-image ``(macs, weight_bytes, act_in_bytes, act_out_bytes)`` of
    each unit, 2-byte elements: what the cost model maps."""
    chs, nc, hw = conf["stage_channels"], conf["num_classes"], conf["img"]
    out = [(9 * 3 * chs[0] * hw * hw, 9 * 3 * chs[0] * 2, hw * hw * 3 * 2,
            hw * hw * chs[0] * 2)]
    for cin, cout, stride, proj in _blocks(chs):
        o = hw // stride
        macs = 9 * cin * cout * o * o + 9 * cout * cout * o * o
        wp = 9 * cin * cout + 9 * cout * cout
        if proj:
            macs += cin * cout * o * o
            wp += cin * cout
        out.append((macs, wp * 2, hw * hw * cin * 2, o * o * cout * 2))
        hw = o
    out.append((chs[3] * nc, chs[3] * nc * 2, chs[3] * 2, nc * 2))
    return out


# ------------------------------------------------------ weights and inputs
def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def make_weights(conf, seed: int, device) -> list[dict]:
    """He-normal weights (std sqrt(2 / fan_in)), zero biases, float32: one
    draw on the device for the whole network, cut into the leaves."""
    shapes = leaf_shapes(conf)
    sizes = [math.prod(s) for u in shapes for p, s in u.items()
             if not p.endswith("b")]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = [], 0
    for u in shapes:
        leaves = {}
        for path, shape in u.items():
            if path.endswith("b"):
                leaves[path] = torch.zeros(shape, device=device)
                continue
            n = math.prod(shape)
            fan_in = math.prod(shape[:-1])
            leaves[path] = flat[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        out.append(_unflatten(leaves))
    return out


def make_images(conf, seed: int, device) -> torch.Tensor:
    """``[n_eval, img, img, 3]`` float32: class prototypes (a sinusoidal
    grating plus a Gaussian blob, tinted) with Gaussian noise, each image
    of a class drawn uniformly.  The prototypes come from numpy, the
    classes and the noise from a generator on the device."""
    nc, img, n = conf["num_classes"], conf["img"], conf["n_eval"]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
    protos = []
    for _ in range(nc):
        fx, fy = rng.uniform(2, 8, 2)
        phase, ang = rng.uniform(0, 2 * np.pi), rng.uniform(0, np.pi)
        g = np.sin(2 * np.pi * (fx * (xx * np.cos(ang) + yy * np.sin(ang))
                                + fy * (yy * np.cos(ang) - xx * np.sin(ang)))
                   + phase)
        cx, cy = rng.uniform(0.25, 0.75, 2)
        s = rng.uniform(0.05, 0.2)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2)))
        protos.append((g[..., None] * 0.6 + blob[..., None] * 0.8)
                      * rng.uniform(-1, 1, 3))
    protos = torch.as_tensor(np.stack(protos).astype(np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cls = torch.randint(0, nc, (n,), generator=gen, device=device)
    noise = torch.randn((n, img, img, 3), generator=gen, device=device)
    return protos[cls] + conf["image_noise"] * noise


def labels_spread(labels: torch.Tensor, conf) -> bool:
    """The fixed rule for a usable draw of weights: the clean argmax takes
    at least two classes and no class takes all but a 32nd of the images
    (a collapsed head keeps its argmax under any fault, and ΔAcc would
    read 0)."""
    n = conf["n_eval"]
    counts = torch.bincount(labels, minlength=conf["num_classes"])
    return int((counts > 0).sum()) >= 2 and \
        int(counts.max()) <= n - max(1, n // 32)


def make(conf, rng_weights, rng_inputs, device) -> dict:
    """The run's images and weights: draws of weights from the weights'
    stream until one passes :func:`labels_spread`."""
    x = make_images(conf, int(rng_inputs.integers(0, 2 ** 62)), device)
    for _ in range(16):
        params = make_weights(conf, int(rng_weights.integers(0, 2 ** 62)),
                              device)
        if labels_spread(Reference(conf, params, x).labels, conf):
            return {"params": params, "x": x}
    raise RuntimeError("16 draws of weights in a row collapsed the labels")


# ----------------------------------------------------------------- forward
def _same(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride=1):
    """NHWC ``x`` with an HWIO ``w``, NHWC out, the bias added after.  The
    convolution runs on the NHWC data itself, as a channels-last NCHW view
    (a contiguous NCHW copy takes other cuDNN algorithms, whose rounding
    the fault model amplifies: PERF.md, "How correct is decided")."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _same(x.shape[1], kh, stride), _same(x.shape[2], kw, stride)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(xc, wc, stride=stride).permute(0, 2, 3, 1) + b


def unit_forward(conf, i: int, p: dict, x: torch.Tensor) -> torch.Tensor:
    if i == 0:
        return F.relu(_conv(x, p["conv"]["w"], p["conv"]["b"]))
    if i == N_UNITS - 1:
        return x @ p["w"] + p["b"]
    _, _, stride, proj = _blocks(conf["stage_channels"])[i - 1]
    h = F.relu(_conv(x, p["c1"]["w"], p["c1"]["b"], stride))
    h = _conv(h, p["c2"]["w"], p["c2"]["b"])
    sc = _conv(x, p["proj"]["w"], p["proj"]["b"], stride) if proj else x
    x = F.relu(h + sc)
    return x.mean(dim=(1, 2)) if i == N_UNITS - 2 else x


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class Reference:
    """The plain model over one draw of weights and images.  ``labels``,
    ``clean`` and :meth:`delta_acc` are its own, from the weights and
    images alone."""

    def __init__(self, conf, params, x, precision: str = "fp32"):
        self.conf, self.params, self.x = conf, params, x
        self.tf32 = {"fp32": False, "tf32": True}[precision]
        fp = conf["fault"]
        self.bits, self.faulty = fp["bits"], fp["faulty_bits"]
        self.base = conf["base_seed"]
        with self._precision():
            logits = self._forward(
                [self._corrupt_leaves(i, p, None) for i, p in
                 enumerate(params)], [None] * N_UNITS)
        self.labels = logits.argmax(-1)
        self.clean = 1.0          # the clean pass is what the labels are of

    @contextlib.contextmanager
    def _precision(self):
        """TF32 in cuDNN and matmuls as the precision says, restored on
        exit."""
        mm = torch.backends.cuda.matmul
        saved = (torch.backends.cudnn.allow_tf32, mm.allow_tf32)
        torch.backends.cudnn.allow_tf32 = mm.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, mm.allow_tf32 = saved

    def _corrupt_leaves(self, i, p, rates):
        """Unit ``i``'s tree with every weight leaf corrupted at each of
        ``rates`` (None: quantized, nothing flipped); one tree a rate."""
        seed = fault.unit_seed(self.base, i)
        flat = {}
        for j, (path, w) in enumerate(_leaves(p)):
            if w.ndim < 2:
                flat[path] = [w] * (1 if rates is None else len(rates))
            elif rates is None:
                flat[path] = [fault.corrupt(w, self.bits, None)]
            else:
                flat[path] = fault.corrupted_weights(
                    w, self.bits, seed + fault.LEAF_STRIDE * j, rates,
                    self.faulty)
        n = 1 if rates is None else len(rates)
        trees = [_unflatten({k: v[d] for k, v in flat.items()})
                 for d in range(n)]
        return trees[0] if rates is None else trees

    def _act_masks(self, a_rates):
        """Each unit's input flip masks, one a device: ``[D, n]``."""
        masks, x = [], self.x
        for i in range(N_UNITS):
            n = x.numel()
            seed = fault.unit_seed(self.base, i) + fault.ACT_OFFSET
            masks.append(fault.flip_masks(n, seed, a_rates, self.faulty,
                                          x.device))
            x = torch.empty(self._out_shape(i, x.shape), device=x.device)
        return masks

    def _out_shape(self, i, shape):
        chs, nc = self.conf["stage_channels"], self.conf["num_classes"]
        if i == 0:
            return (*shape[:3], chs[0])
        if i == N_UNITS - 1:
            return (shape[0], nc)
        _, cout, stride, _ = _blocks(chs)[i - 1]
        if i == N_UNITS - 2:
            return (shape[0], cout)
        return (shape[0], shape[1] // stride, shape[2] // stride, cout)

    def _forward(self, unit_params, act_masks):
        x = self.x
        for i in range(N_UNITS):
            x = fault.corrupt(x, self.bits, act_masks[i])
            x = unit_forward(self.conf, i, unit_params[i], x)
        return x

    @torch.no_grad()
    def delta_acc(self, rows: np.ndarray, device_scale: np.ndarray
                  ) -> np.ndarray:
        """ΔAcc of each mapping of ``rows [N, 10]`` under the per-device
        fault scale ``device_scale`` (rates = base rate x scale, float32)."""
        rates = fault_rates(self.conf, device_scale)
        with self._precision():
            tables = [self._corrupt_leaves(i, p, rates["weight"])
                      for i, p in enumerate(self.params)]
            masks = self._act_masks(rates["act"])
            out = []
            for row in np.asarray(rows):
                logits = self._forward(
                    [tables[i][d] for i, d in enumerate(row)],
                    [masks[i][d] for i, d in enumerate(row)])
                acc = (logits.argmax(-1) == self.labels).float().mean()
                out.append(max(0.0, self.clean - float(acc)))
        return np.asarray(out)


def fault_rates(conf, device_scale) -> dict:
    """Per-device weight and activation rates, float32 as the
    configuration states them: base rate times the device's scale."""
    scale = np.asarray(device_scale, np.float32)
    f = conf["fault"]
    return {"weight": np.asarray(f["weight_fault_rate"] * scale, np.float32),
            "act": np.asarray(f["act_fault_rate"] * scale, np.float32)}


def latency_energy(conf, rows):
    return cost.latency_energy(layers(conf), conf["ladder"], np.asarray(rows))
