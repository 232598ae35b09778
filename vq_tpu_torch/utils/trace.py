"""Spans at the port's layer boundaries: the host's time in each stage of a
request.

``with span(name):`` times its block on the host clock
(``time.perf_counter_ns``) and adds the duration, under its name, to the
record of the root span open in its thread: the one with no span above it,
one request.  Spans nest, and each thread keeps its own open record, so a
server's threads never mix their records.  When a root closes, its record
``{span name: seconds summed in this request}`` joins a bounded deque of
the newest records; ``recent(root, n)`` reads them, ``reset()`` clears
them.

While ``torch.profiler`` records, a span also opens a CPU range of its
name in the profiler (``_RecordFunctionFast``: a plain CPU event, not a
user annotation, so CUPTI adds no device interval for it).  Kineto stamps
CPU ranges and the device's activity on one clock, so a trace names each
idle stretch of the card after the innermost span open over it.  A root
that the profiler traced keeps no record: the profiler's own cost per op
would inflate it, and its trace holds its spans.

A span never synchronises the device and allocates no tensor.  What it
times is the host's part: the enqueue of the work, and waits only where the
work itself waits (``search.fetch``, the copy of the answers to the host).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

KEEP = 256  # newest root records kept, over every root name

_records: collections.deque = collections.deque(maxlen=KEEP)  # (root name, ns by name)
_thread = threading.local()  # .ns: the open root's record in this thread, None between


class span:
    """``with span(name):`` adds the block's host time under ``name`` to the
    open request's record (the module docstring)."""

    __slots__ = ("name", "_t0", "_range", "_root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self._root = getattr(_thread, "ns", None) is None
        if self._root:
            _thread.ns = {}
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        ns = _thread.ns
        ns[self.name] = ns.get(self.name, 0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._root:
            _thread.ns = None
            if self._range is None:
                _records.append((self.name, ns))


def recent(root: str, n: int) -> List[Dict[str, float]]:
    """The newest ``n`` records of roots named ``root``, oldest first, in
    seconds by span name."""
    found = [ns for name, ns in list(_records) if name == root][-n:] if n > 0 else []
    return [{k: v * 1e-9 for k, v in ns.items()} for ns in found]


def reset() -> None:
    """Forget every record."""
    _records.clear()
