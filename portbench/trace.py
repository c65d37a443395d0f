"""The traced windows of a ``--trace 1`` run, reduced in memory to what the
per-layer readers take.  Nothing is written to disk.

A run's measured window is never traced.  After it, the harness drives the mix's
``trace_items`` items twice more:

* ``device`` phase: ``torch.profiler`` with CUDA activity alone (CUPTI records of
  kernels, copies and sets, no host ops), so the host runs at its own pace.
  Its window is the host clock around the items, each end synchronised; the
  device's busy time is the union of its records.  The idle share, the copies
  and the top device operations come from here.
* ``host`` phase: CPU and CUDA activity with the ops' shapes, marked with
  ``record_function`` spans (``portbench.window``, ``portbench.item``).  The
  profiler's cost per host op slows the host here, so this phase gives only
  what does not depend on the host's pace: the shapes of each kernel launch,
  the kernels' own device times, and which host op covers each idle gap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional

import torch

WINDOW = "portbench.window"
ITEM = "portbench.item"


@dataclasses.dataclass
class Op:
    name: str
    start: int  # ns
    end: int
    shapes: list
    dtypes: list
    concrete: list
    thread: int


@dataclasses.dataclass
class Trace:
    """The reduced phases.  ``device`` and ``window_s``: the device phase's
    records and host-clock length; ``units`` the work its items did (frames,
    images).  ``host`` and ``launched``: the host phase's CPU ops (by start
    time) and device records.  ``rate``: the measured window's units a second;
    ``entry``: the cell's entry (its operation counts)."""

    device: List[Op]
    window_s: float
    units: int
    host: List[Op]
    launched: List[Op]
    host_window: tuple = (0, 0)
    rate: float = 0.0
    entry: object = None
    _flops: Optional[Dict[str, float]] = None

    def ops(self, name: str) -> List[Op]:
        return [o for o in self.host if o.name == name]

    def last_before(self, op: Op, name: str) -> Optional[Op]:
        before = [o for o in self.ops(name) if o.start < op.start and o.thread == op.thread]
        return before[-1] if before else None

    def kernels(self, pattern: str) -> List[Op]:
        """The host phase's records of the kernels whose name matches."""
        rx = re.compile(pattern)
        return [d for d in self.launched if rx.search(d.name)]

    def copies(self, kind: str) -> List[Op]:
        return [d for d in self.device if d.name.startswith("Memcpy " + kind)]

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.device)) / 1e9

    def flops(self) -> Dict[str, float]:
        if self._flops is None:
            self._flops = self.entry.flops_per_unit()
        return self._flops

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (device phase), and the
        longest idle gaps of the host phase, each named by the host op that
        covers most of it (the innermost of ops that cover as much)."""
        by_name: Dict[str, float] = {}
        for d in self.device:
            by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.host_window
        gaps, prev = [], lo
        for s, e in _union(self.launched, lo, hi) + [[hi, hi]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            best, most = None, 0
            for o in self.host:
                if o.start >= e:
                    break
                cover = min(o.end, e) - max(o.start, s)
                if cover > 0 and cover >= most and not o.name.startswith("portbench."):
                    best, most = o, cover
            named.append([best.name if best else "(no host op)", (e - s) / 1e9])
        return {"device_ops": [[_short(n), v] for n, v in ops], "idle_gaps": named}


def _union(records: List[Op], lo: int = None, hi: int = None) -> List[List[int]]:
    spans = sorted((d.start if lo is None else max(d.start, lo),
                    d.end if hi is None else min(d.end, hi)) for d in records)
    out: List[List[int]] = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


@contextlib.contextmanager
def capture(device: str, host: bool):
    """Profile the enclosed items: CUDA activity (on a card), and with ``host``
    the CPU ops and their shapes.  Yields a dict that holds the raw events
    after the block ends."""
    acts = []
    if host or device != "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    box: Dict[str, object] = {}
    with torch.profiler.profile(activities=acts, record_shapes=host) as prof:
        yield box
        if device == "cuda":
            torch.cuda.synchronize()
    box["events"] = prof.profiler.kineto_results.events()


def _split(events, lo: int = None, hi: int = None):
    """-> (device records, host ops by start), within [lo, hi] when given."""
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if lo is not None and (t < lo or s > hi):
            continue
        is_dev = e.device_type() != torch.autograd.DeviceType.CPU
        if is_dev and (e.is_user_annotation() or e.name().startswith("portbench.")):
            continue  # a record_function span mirrored on the device's timeline
        op = Op(e.name(), s, t, [] if is_dev else list(e.shapes()),
                [] if is_dev else list(e.dtypes()),
                [] if is_dev else list(e.concrete_inputs()), e.start_thread_id())
        (device if is_dev else host).append(op)
    host.sort(key=lambda o: o.start)
    return device, host


def reduce(device_events, window_s: float, units: int, host_events, rate: float,
           entry) -> Trace:
    """The two phases' raw kineto events -> a ``Trace``."""
    device, _ = _split(device_events)
    win = [e for e in host_events if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the host phase has no portbench.window span")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    launched, host = _split(host_events, lo, hi)
    return Trace(device, window_s, units, host, launched, (lo, hi), rate, entry)
