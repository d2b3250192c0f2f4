"""The program's own spans (``repro_torch.trace``) over the traced
sub-window: each idle interval of the device put down to the layer of the
innermost program span open on the host, and a layer's time less its
children's.

A span's layer is the prefix of its name (``search.``, ``engine.``,
``forward.``, ``kernel.``); time under no program span is the benchmark's
own (``"none"``).  The spans are read from the program's ring in memory,
on the profiler's clock, so they line up with ``Trace.window_ns`` and
each card's ``Trace.busy_by_card``.  A program without the tracer gives None.
"""
from __future__ import annotations

import collections

from bench.profile_reader import idle_intervals

LAYERS = {"search": "search", "engine": "engine", "forward": "forward",
          "kernel": "kernels"}


def program_spans(ctx):
    """The program's spans that overlap the traced sub-window, or None
    (no trace, or a program without ``repro_torch.trace``)."""
    if ctx.trace is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.spans(*ctx.trace.window_ns)


def layer_of(name: str | None) -> str:
    if name is None:
        return "none"
    head = name.split(".", 1)[0]
    return LAYERS.get(head, head)


def innermost(spans, lo: int, hi: int) -> list[tuple[int, int, str | None]]:
    """``[lo, hi)`` cut into disjoint pieces ``(a, b, name)`` in time
    order, each labelled by the innermost span open over it (None where
    none is).  Spans nest on the thread that opened them; a span that
    outlives the one it opened in is cut at its end."""
    out: list = []

    def emit(a, b, name):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, name))

    stack: list = []              # (end, name), innermost last
    cur = lo
    for s in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        while stack and stack[-1][0] <= s.t0_ns:
            end, name = stack.pop()
            emit(cur, end, name)
            cur = max(cur, end)
        emit(cur, s.t0_ns, stack[-1][1] if stack else None)
        cur = max(cur, s.t0_ns)
        end = min(s.t1_ns, stack[-1][0]) if stack else s.t1_ns
        stack.append((end, s.name))
    while stack:
        end, name = stack.pop()
        emit(cur, end, name)
        cur = max(cur, end)
    emit(cur, hi, None)
    return out


def idle_ns_by_layer(ctx) -> dict[str, int] | None:
    """Idle nanoseconds of the traced window by the layer of the innermost
    program span open at each instant (exact intersection), ``"none"``
    for time under no program span, each card's idle intervals apart and
    summed over the cell's cards; the values add up to the cards' idle
    time.  Computed once a run."""
    if not hasattr(ctx, "program_idle_ns"):
        spans = program_spans(ctx)
        if spans is None:
            ctx.program_idle_ns = None
        else:
            tr = ctx.trace
            pieces = innermost(spans, *tr.window_ns)
            out: dict = collections.defaultdict(int)
            for busy in tr.busy_by_card:
                idle = idle_intervals(tr.window_ns, busy)
                i = j = 0
                while i < len(pieces) and j < len(idle):
                    a = max(pieces[i][0], idle[j][0])
                    b = min(pieces[i][1], idle[j][1])
                    if b > a:
                        out[layer_of(pieces[i][2])] += b - a
                    if pieces[i][1] < idle[j][1]:
                        i += 1
                    else:
                        j += 1
            ctx.program_idle_ns = dict(out)
    return ctx.program_idle_ns


def idle_share(ctx, layer: str) -> float | None:
    """Percent of the traced window a card is idle while the host's
    innermost program span is of ``layer``, the mean over the cell's
    cards."""
    by = idle_ns_by_layer(ctx)
    if by is None:
        return None
    lo, hi = ctx.trace.window_ns
    return 100.0 * by.get(layer, 0) / ((hi - lo) * len(ctx.trace.busy_by_card))
