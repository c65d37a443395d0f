"""Profiling hooks: Chrome traces, and the program's spans and counters.

Port of ``seam_match_rcnn_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of the enclosed region and writes it into
``log_dir`` as a Chrome trace (``*.pt.trace.json``, which Perfetto and
TensorBoard open), and ``annotate`` names a region inside it.

``annotate`` is also the program's span, and ``count`` its counter.  Both
record only while a torch profiler is active on the calling thread
(``torch.autograd._profiler_enabled()``), and never while ``torch.export``
or ``torch.compile`` traces the code.  Outside a profiler that one check is
their whole cost.  While it records, a span opens a ``record_function``
range of its name (so it shows in the profiler's own events) and, when it
closes, appends a ``Span`` to a bounded in-memory store, timed with
``time.time_ns()``, the clock of the profiler's host events.  A span opened
while no other span is open on its thread is a root: it starts a new
``item``, which every span and count inside it shares.  ``records()``
returns the store, oldest first; it keeps the newest ``CAP`` records and
counts those it dropped (``dropped()``).  Nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import List, NamedTuple, Optional, Union

import torch

CAP = 1 << 16  # records the store keeps


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[str]  # the enclosing span's name; None for a root
    item: int  # the root's id
    thread: int


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int
    item: Optional[int]  # the enclosing root's id; None outside any span
    thread: int


class Store:
    """The newest ``cap`` records, and the number of older ones dropped."""

    def __init__(self, cap: int = CAP):
        self.records = collections.deque(maxlen=cap)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, record) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


_store = Store()
_items = itertools.count(1)
_open = threading.local()  # .spans: this thread's open spans, innermost last
_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
_compiling = torch.compiler.is_compiling


def _stack() -> list:
    spans = getattr(_open, "spans", None)
    if spans is None:
        spans = _open.spans = []
    return spans


class _Span:
    __slots__ = ("name", "parent", "item", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.item = stack[-1].name, stack[-1].item
        else:
            self.parent, self.item = None, next(_items)
        stack.append(self)
        self.t0 = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            t1 = time.time_ns()
            _stack().pop()
            _store.add(Span(self.name, self.t0, t1, self.parent, self.item,
                            threading.get_ident()))
        return False


def annotate(name: str):
    """A named span of the program: a region inside an active trace, and a
    ``Span`` record in the store (see the module's docstring).  A no-op
    context outside a profiler and under export or compile."""
    return _Span(name) if _profiler_enabled() and not _compiling() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the store under ``name``, stamped with
    the time and the enclosing root's item, while a profiler is active.
    Takes host values only: reading a device tensor here would add a
    synchronisation to the traced window."""
    if _profiler_enabled() and not _compiling():
        stack = _stack()
        _store.add(Count(name, time.time_ns(), int(n), stack[0].item if stack else None,
                         threading.get_ident()))


def records() -> List[Union[Span, Count]]:
    """The store's records, oldest first."""
    with _store.lock:
        return list(_store.records)


def dropped() -> int:
    """How many records the store's cap pushed out since the last ``clear``."""
    return _store.dropped


def clear() -> None:
    with _store.lock:
        _store.records.clear()
        _store.dropped = 0


@contextlib.contextmanager
def trace(log_dir: str, device: str = "cuda"):
    """Capture a trace of the enclosed region into ``log_dir``: CPU and CUDA
    activity for ``device="cuda"`` (the default, which needs a card), CPU
    activity alone for ``device="cpu"``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device; pass device='cpu' to trace the CPU only")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"trace: device {device!r}, expected 'cuda' or 'cpu'")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if device == "cuda":
            torch.cuda.synchronize()
