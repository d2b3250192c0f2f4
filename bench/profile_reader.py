"""Reads ``torch.profiler``'s record of a traced sub-window into what the
per-layer metrics need: each device operation's interval and name, their
time by group, the union of the intervals (busy), the idle gaps labelled
by what the host was doing, and the ``breakdown`` of the result line.

The record is read in memory (the profiler's event list); nothing of it
is written to disk.  A gap is labelled by the benchmark span open on the
host at its middle and the outermost operation running inside it there
(``python`` where none was: the host was in Python code).
"""
from __future__ import annotations

import bisect
import collections
import re

from torch.autograd import DeviceType

# what PyTorch and the libraries run around the port's kernels
GLUE = ("elementwise", "copies", "layout")


def kernel_group(name: str, library: str) -> str:
    """The group of a device operation: one of the port's kernels, glue,
    or the library's own (``library``: cuDNN's convolutions on a CNN,
    cuBLAS's products on a transformer)."""
    if "quant_bitflip_kernel" in name or "amax_kernel" in name:
        return "quant_bitflip"
    if "bitflip_kernel" in name:
        return "bitflip"
    if "bfp::hash_kernel" in name:
        return "fault_weight_tiles"
    if "bfp::product_kernel" in name or \
            "sum_splits_kernel<__nv_bfloat16>" in name:
        return "matmul_tiles"
    if "fwp::product_kernel" in name:
        return "matmul_tiles_f32"
    if "simt::kernel" in name or "tc::kernel" in name or "sum_splits" in name:
        return "fault_matmul"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    if "nhwcToNchw" in name or "nchwToNhwc" in name:
        return "layout"
    if "at::native" in name or "at_cuda_detail" in name:
        return "elementwise"
    return library


class Trace:
    """The device operations and host spans of one profiled sub-window."""

    def __init__(self, prof, library: str, on_card: bool = True):
        """``on_card=False`` (a rehearsal on the host) takes the host's
        outermost operations for the device's."""
        kern, cpu, spans, window = [], [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith("bench:"):
                    continue
                kern.append((t0, t1, name))
            elif name == "bench:trace":
                window = (t0, t1)
            elif name.startswith("bench:"):
                spans.append((t0, t1, name))
            elif name.startswith(("aten::", "cuda", "cu")) and not \
                    e.is_async():
                cpu.append((t0, t1, name))
        if window is None:
            raise RuntimeError("the profiler recorded no traced span")
        if not on_card:
            kern = self._outermost(sorted(cpu))
        self.window_ns = window
        lo, hi = window
        self.kernels = sorted((max(a, lo), min(b, hi), n) for a, b, n in kern
                              if b > lo and a < hi)
        if not self.kernels:
            raise RuntimeError("the profiler recorded no device operation: "
                               "time with CUDA events instead")
        self.groups = collections.defaultdict(float)
        self.by_name = collections.defaultdict(float)
        for a, b, n in self.kernels:
            self.groups[kernel_group(n, library)] += (b - a) * 1e-9
            self.by_name[n] += (b - a) * 1e-9
        self.busy_intervals = self._union()
        self.busy_s = sum(b - a for a, b in self.busy_intervals) * 1e-9
        self.window_s = (hi - lo) * 1e-9
        self._spans = sorted(spans)
        self._top = self._outermost(sorted(cpu))

    def _union(self):
        out = []
        for a, b, _ in self.kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @staticmethod
    def _outermost(cpu):
        out, end = [], -1
        for a, b, n in cpu:
            if a >= end:
                out.append((a, b, n))
                end = b
        return out

    def _host_at(self, t: int) -> str:
        span = "outside"
        for a, b, n in self._spans:
            if a <= t < b:
                span = n          # the innermost: spans nest in start order
            elif a > t:
                break
        k = bisect.bisect_right(self._top, (t, float("inf"), "")) - 1
        op = "python"
        if k >= 0 and self._top[k][0] <= t < self._top[k][1]:
            op = self._top[k][2]
        return f"{span}/{op}"

    def idle_gaps(self) -> dict[str, float]:
        """Idle seconds by what the host was doing."""
        lo, hi = self.window_ns
        edges = [lo] + [t for iv in self.busy_intervals for t in iv] + [hi]
        gaps = collections.defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_at((a + b) // 2)] += (b - a) * 1e-9
        return gaps

    def group_s(self, *names) -> float:
        return sum(self.groups.get(n, 0.0) for n in names)

    def breakdown(self, top: int = 10) -> dict:
        def short(n):
            return re.sub(r"\s+", " ", n)[:160]
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
