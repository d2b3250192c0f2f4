"""Host milliseconds a ``search.generation`` span outside the
``engine.delta_acc`` spans it caused, over the generation spans that lie
whole in the traced sub-window: the program's own count of what
``search_host_ms`` reads from the benchmark's spans (a search's first
span also scores the initial population; its last extracts the front)."""
from bench.program_spans import program_spans


def read(ctx):
    if ctx.traffic["kind"] != "search":
        return None
    spans = program_spans(ctx)
    if spans is None:
        return None
    lo, hi = ctx.trace.window_ns
    index = {s.index: s for s in spans}
    self_ns = {s.index: s.t1_ns - s.t0_ns for s in spans
               if s.name == "search.generation"
               and lo <= s.t0_ns and s.t1_ns <= hi}
    if not self_ns:
        return None
    for s in spans:
        if s.name != "engine.delta_acc":
            continue
        p = index.get(s.parent)
        while p is not None and p.index not in self_ns:
            p = index.get(p.parent)
        if p is not None:
            self_ns[p.index] -= s.t1_ns - s.t0_ns
    return sum(self_ns.values()) * 1e-6 / len(self_ns)
