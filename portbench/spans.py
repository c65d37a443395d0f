"""The program's own spans and counters, read against a ``--trace 1`` run's
``Trace``: which program step the host was in while the card sat idle.

The program (``seam_match_rcnn_tpu_torch.utils.profiling``) records spans and
counters only while a torch profiler runs, so its store holds the records of
both traced phases.  The split is read from the device phase alone, where
only CUDA activity is profiled and the host runs at its own pace: the records
that end before the host phase's ``portbench.window`` and start no earlier
than the phase's last device record less its length.  Each instant of a span
on the root spans' thread (``seam.call`` or ``seam.step``) belongs to the
innermost span open then (self time, so NMS is not counted again under the
forward); the instants of it with no CUPTI record are its idle time, over the
phase's host-clock length.

Reads None where the device phase holds no root span or no span of the name
asked for, where the store dropped records (its cap keeps the newest, so the
device phase's would go first), and where the program keeps no store: the
traced runs lay this benchmark over the parent program too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .trace import _union

ROOTS = ("seam.call", "seam.step")


def program_records() -> list:
    """The program's store; [] where the program keeps none, or where its
    cap dropped records, so a truncated phase reads as missing and not as a
    smaller share."""
    try:
        from seam_match_rcnn_tpu_torch.utils.profiling import dropped, records
    except ImportError:
        return []
    return [] if dropped() else records()


def _is_span(r) -> bool:
    return hasattr(r, "t1_ns")


def phase(trace, recs) -> Optional[dict]:
    """The device phase's records -> {"spans": those on the roots' thread,
    "counts", "busy": the device's union in ns, "window_ns"}, or None where
    the phase holds no root span."""
    if not trace.device or trace.window_s <= 0:
        return None
    window_ns = int(trace.window_s * 1e9)
    start, end = max(d.end for d in trace.device) - window_ns, trace.host_window[0]
    spans = [r for r in recs if _is_span(r) and r.t0_ns >= start and r.t1_ns <= end]
    roots = [s for s in spans if s.parent is None and s.name in ROOTS]
    if not roots:
        return None
    thread = roots[0].thread
    return {"spans": [s for s in spans if s.thread == thread],
            "counts": [r for r in recs if not _is_span(r) and start <= r.t_ns <= end],
            "busy": _union(trace.device), "window_ns": window_ns}


def self_pieces(spans) -> List[tuple]:
    """Properly nested spans of one thread -> disjoint (start, end, name)
    pieces, each instant under its innermost span."""
    out, stack, cur = [], [], 0
    for s in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        while stack and stack[-1].t1_ns <= s.t0_ns:
            top = stack.pop()
            out.append((cur, top.t1_ns, top.name))
            cur = top.t1_ns
        if stack:
            out.append((cur, s.t0_ns, stack[-1].name))
        stack.append(s)
        cur = s.t0_ns
    while stack:
        top = stack.pop()
        out.append((cur, top.t1_ns, top.name))
        cur = top.t1_ns
    return [p for p in out if p[1] > p[0]]


def idle_ns(pieces, busy) -> Dict[str, int]:
    """Each span name's idle time: its pieces' length less their overlap with
    the sorted, disjoint ``busy`` intervals."""
    out: Dict[str, int] = {}
    j = 0
    for a, b, name in pieces:  # pieces are sorted and disjoint
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        out[name] = out.get(name, 0) + (b - a) - covered
    return out


def idle_pct(trace, name: str, recs=None) -> Optional[float]:
    """Share of the phase's window in which the card was idle while ``name``
    was the innermost open span on the roots' thread, in %."""
    ph = phase(trace, program_records() if recs is None else recs)
    if ph is None or not any(s.name == name for s in ph["spans"]):
        return None
    idle = idle_ns(self_pieces(ph["spans"]), ph["busy"])
    return 100.0 * idle.get(name, 0) / ph["window_ns"]


def steps_per_call(trace, recs=None) -> Optional[float]:
    """``nms.steps`` over ``nms.calls`` in the phase: Jacobi steps an NMS call."""
    ph = phase(trace, program_records() if recs is None else recs)
    if ph is None:
        return None
    calls = sum(c.n for c in ph["counts"] if c.name == "nms.calls")
    steps = sum(c.n for c in ph["counts"] if c.name == "nms.steps")
    return steps / calls if calls else None
