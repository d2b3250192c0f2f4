"""Reads ``torch.profiler``'s record of a traced sub-window into what the
per-layer metrics need: each device operation's interval, name and card,
their time by group (summed over the cards), each card's union of
intervals (busy), the idle gaps labelled by what the host was doing, and
the ``breakdown`` of the result line.

The record is read in memory (the profiler's event list); nothing of it
is written to disk.  A gap is labelled by the benchmark span open on the
host at its middle and the outermost operation running inside it there
(``python`` where none was: the host was in Python code); a card that ran
nothing in the window is labelled by its index alone.
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


def idle_intervals(window, busy) -> list[tuple[int, int]]:
    """``window`` less the union ``busy`` of one card's intervals."""
    lo, hi = window
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


class Trace:
    """The device operations and host spans of one profiled sub-window,
    over the cards of a cell: each card's busy intervals apart, their
    operations' time summed."""

    def __init__(self, window, kernels, cpu, spans, library: str, cards):
        """``window``: the traced span ``(t0, t1)``; ``kernels``: device
        operations ``(t0, t1, name, card)``; ``cpu``: the host's operations
        ``(t0, t1, name)``; ``spans``: the benchmark's host spans;
        ``cards``: the device indices of the cell's cards."""
        self.window_ns = window
        self.cards = list(cards)
        lo, hi = window
        self.kernels = sorted((max(a, lo), min(b, hi), n, c)
                              for a, b, n, c in kernels
                              if b > lo and a < hi and c in self.cards)
        if not self.kernels:
            raise RuntimeError("the profiler recorded no device operation: "
                               "time with CUDA events instead")
        self.groups = collections.defaultdict(float)
        self.by_name = collections.defaultdict(float)
        for a, b, n, _ in self.kernels:
            self.groups[kernel_group(n, library)] += (b - a) * 1e-9
            self.by_name[n] += (b - a) * 1e-9
        self.busy_by_card = [self._union([k for k in self.kernels
                                          if k[3] == c]) for c in self.cards]
        self.busy_s_per_card = [sum(b - a for a, b in busy) * 1e-9
                                for busy in self.busy_by_card]
        # the mean over the cards: busy_s / window_s is the card-time share
        self.busy_s = sum(self.busy_s_per_card) / len(self.cards)
        self.window_s = (hi - lo) * 1e-9
        self._spans = sorted(spans)
        self._top = self._outermost(sorted(cpu))

    @classmethod
    def read(cls, prof, library: str, cards, on_card: bool = True):
        """The profiler's record in memory.  ``on_card=False`` (a rehearsal
        on the host) takes the host's outermost operations for the first
        card's."""
        kern, cpu, spans, window = [], [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith("bench:"):
                    continue
                kern.append((t0, t1, name, e.device_index()))
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
            kern = [(a, b, n, cards[0])
                    for a, b, n in cls._outermost(sorted(cpu))]
        return cls(window, kern, cpu, spans, library, cards)

    @staticmethod
    def _union(kernels):
        out = []
        for a, b, *_ in kernels:
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
        """Idle card-seconds by what the host was doing, every card's gaps
        gathered.  A card that ran nothing in the window is one entry of
        its own, ``card<index>/idle``: its one gap spans the whole window,
        and the host's state at its middle would say nothing of it."""
        gaps = collections.defaultdict(float)
        for card, busy in zip(self.cards, self.busy_by_card):
            if not busy:
                gaps[f"card{card}/idle"] += self.window_s
                continue
            for a, b in idle_intervals(self.window_ns, busy):
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
