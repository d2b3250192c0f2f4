"""The port's one tracer: spans at its layer boundaries, on the profiler's
clock.

``span(name)`` is a context manager.  While no ``torch.profiler.profile``
(or ``torch.autograd.profiler.profile``) is recording, it returns one
shared null context and does nothing else: no ``record_function``, no
clock read, no allocation.  While a profiler records on the calling
thread (a profiler records on the thread that started it), it opens
``record_function("afp:" + name)``, so the profiler holds the span on the
device trace's clock (``prof.export_chrome_trace`` carries the ``afp:``
ranges; there is no exporter here), and keeps ``Span(name, t0_ns, t1_ns,
parent, index)`` in a ring of the newest ``RING`` spans.  ``t0_ns`` and
``t1_ns`` are ``time.time_ns()``, the profiler's clock, read inside the
range; ``index`` numbers the spans in the order they opened, and
``parent`` is the index of the span open on the same thread when this one
opened (-1 for none): the span that caused it.

The prefix of a name is its layer: ``search.``, ``engine.``,
``forward.``, ``kernel.`` (and ``train.``).  ``spanned(name)`` runs a
decorated function inside ``span(name)``.  ``spans(lo_ns, hi_ns)``
returns the kept spans that overlap a window.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch._C._autograd import _profiler_enabled as _recording

__all__ = ["span", "spanned", "spans", "Span", "RING"]

RING = 1 << 20


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    index: int


_NULL = contextlib.nullcontext()
_ring: collections.deque = collections.deque(maxlen=RING)
_numbers = itertools.count()
_local = threading.local()


class _Open:
    __slots__ = ("name", "rf", "parent", "index", "t0", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _profiler.record_function("afp:" + self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else -1
        self.index = next(_numbers)
        stack.append(self.index)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.stack.pop()
        _ring.append(Span(self.name, self.t0, t1, self.parent, self.index))
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` while a profiler records on this thread, else
    the shared null context."""
    if not _profiler._is_profiler_enabled or not _recording():
        return _NULL
    return _Open(name)


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def spans(lo_ns: int, hi_ns: int) -> list[Span]:
    """The kept spans that overlap ``[lo_ns, hi_ns)``, in the order they
    opened."""
    return sorted((s for s in list(_ring) if s.t1_ns > lo_ns
                   and s.t0_ns < hi_ns), key=lambda s: s.index)
