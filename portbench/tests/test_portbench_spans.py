"""The idle split's readers give hand-computed values on a synthetic trace and
span store, count NMS once, never split more idle time than the card had, and
read None where the program recorded nothing."""

import sys
import types

import pytest

from portbench import run as R
from portbench import spans
from portbench.trace import Op, Trace
from seam_match_rcnn_tpu_torch.utils.profiling import Count, Span

MS = 1_000_000  # ns
HOST = (200 * MS, 300 * MS)  # the host phase's window, after the device phase


def _busy(*intervals):
    return [Op("kernel", s * MS, e * MS, [], [], [], 0) for s, e in intervals]


def _span(name, t0, t1, parent, item, thread=1):
    return Span(name, int(t0 * MS), int(t1 * MS), parent, item, thread)


def _count(name, t, n, item):
    return Count(name, int(t * MS), n, item, 1)


# the device phase: 100 ms; idle 63 ms in all
DEVICE = _busy((10, 20), (32, 38), (45, 48), (52, 68), (80, 82))
STALE = [_span("seam.call", -1000, -900, None, 1), _count("nms.calls", -950, 5, 1),
         _count("nms.steps", -950, 5, 1)]  # an earlier run in the same process
INDEX = STALE + [
    _span("seam.ingest", 5, 25, "seam.call", 2),
    _span("seam.nms", 40, 50, "seam.forward", 2),
    _count("nms.calls", 41, 1, 2), _count("nms.steps", 42, 1, 2),
    _count("nms.steps", 43, 1, 2), _count("nms.steps", 44, 1, 2),
    _span("seam.forward", 30, 70, "seam.call", 2),
    _span("seam.readback", 75, 95, "seam.call", 2),
    _span("seam.call", 0, 100, None, 2),
    _span("seam.ingest", 0, 100, None, 3, thread=2),  # another thread: not read
    _span("seam.call", 210, 290, None, 4),  # the host phase
]
# training: the ingest runs before the step, a root of its own
TRAIN = [
    _span("seam.ingest", 0, 10, None, 1),
    _span("seam.nms", 21, 26, "seam.forward", 2),
    _count("nms.calls", 22, 1, 2), _count("nms.steps", 23, 1, 2),
    _count("nms.calls", 24, 1, 2), _count("nms.steps", 25, 1, 2),
    _span("seam.forward", 12, 40, "seam.step", 2),
    _span("seam.backward", 42, 80, "seam.step", 2),
    _span("seam.optimizer", 82, 98, "seam.step", 2),
    _span("seam.step", 11, 99, None, 2),
]
INDEX_SPLIT = {"ingest_idle_pct.index": 10.0,  # 5..25 less 10..20
               "fwd_idle_pct.index": 8.0,  # 30..40 less 32..38, 50..70 less 52..68
               "nms_idle_pct.index": 7.0,  # 40..50 less 45..48
               "post_idle_pct.index": 18.0}  # 75..95 less 80..82
TRAIN_SPLIT = {"ingest_idle_pct.train": 10.0,  # 0..10, nothing busy
               "fwd_idle_pct.train": 9.0,  # 12..21 less 12..20, 26..40 less 32..38
               "nms_idle_pct.train": 5.0,  # 21..26, nothing busy
               "bwd_idle_pct.train": 19.0,  # 42..80 less 45..48, 52..68
               "opt_idle_pct.train": 16.0}  # 82..98, nothing busy after 82


def _trace(device=DEVICE, launched=()):
    return Trace(list(device), 0.1, 4, [], list(launched), HOST)


@pytest.fixture
def store(monkeypatch):
    def use(recs):
        monkeypatch.setattr(spans, "program_records", lambda: list(recs))
    return use


def _read(name, trace):
    return R.reader(name).read(trace, None)


def test_index_split_by_hand(store):
    store(INDEX)
    t = _trace()
    for name, want in INDEX_SPLIT.items():
        assert _read(name, t) == pytest.approx(want), name
    assert _read("nms_steps.index", t) == pytest.approx(3.0)
    assert _read("idle_pct.index", t) == pytest.approx(63.0)


def test_train_split_by_hand(store):
    store(TRAIN)
    t = _trace()
    for name, want in TRAIN_SPLIT.items():
        assert _read(name, t) == pytest.approx(want), name
    assert _read("nms_steps.train", t) == pytest.approx(1.0)
    assert _read("post_idle_pct.index", t) is None  # no such span in a step


def test_nms_is_not_counted_again_under_the_forward(store):
    without = [r for r in INDEX if r.name != "seam.nms"]
    store(without)
    whole = _read("fwd_idle_pct.index", _trace())
    store(INDEX)
    t = _trace()
    split = _read("fwd_idle_pct.index", t) + _read("nms_idle_pct.index", t)
    assert whole == pytest.approx(split)


@pytest.mark.parametrize("recs, names", [(INDEX, INDEX_SPLIT), (TRAIN, TRAIN_SPLIT)])
def test_the_split_sums_to_no_more_than_the_idle_share(store, recs, names):
    store(recs)
    t = _trace()
    total = sum(_read(n, t) for n in names)
    assert total <= _read("idle_pct.index", t) + 1e-9
    pieces = spans.self_pieces([r for r in recs if isinstance(r, Span) and r.thread == 1
                                and 0 <= r.t0_ns and r.t1_ns <= 100 * MS])
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))  # disjoint, in order


def test_spans_of_the_host_phase_alone_read_none(store):
    """The split is read from the device phase alone: spans recorded only in
    the host phase, where the profiler slows the host, read None."""
    shift = HOST[0]
    host = [r._replace(t0_ns=r.t0_ns + shift, t1_ns=r.t1_ns + shift) if isinstance(r, Span)
            else r._replace(t_ns=r.t_ns + shift) for r in INDEX[len(STALE):-1]]
    launched = [Op(o.name, o.start + shift, o.end + shift, [], [], [], 0) for o in DEVICE]
    store(host)
    t = _trace(launched=launched)
    for name in list(INDEX_SPLIT) + ["nms_steps.index"]:
        assert _read(name, t) is None, name


def test_a_truncated_store_reads_none(monkeypatch):
    """Once the store's cap has dropped records, the device phase's may be
    among them: every reader reads None, never a smaller share."""
    from seam_match_rcnn_tpu_torch.utils import profiling

    store = profiling.Store(cap=len(INDEX))
    monkeypatch.setattr(profiling, "_store", store)
    for r in INDEX:
        store.add(r)
    t = _trace()
    assert profiling.dropped() == 0
    assert _read("ingest_idle_pct.index", t) == pytest.approx(INDEX_SPLIT["ingest_idle_pct.index"])
    store.add(INDEX[-1])
    assert profiling.dropped() == 1
    for name in list(INDEX_SPLIT) + ["nms_steps.index"]:
        assert _read(name, t) is None, name


def test_nothing_recorded_reads_none(store, monkeypatch):
    names = list(INDEX_SPLIT) + list(TRAIN_SPLIT) + ["nms_steps.index", "nms_steps.train"]
    store([])
    for name in names:
        assert _read(name, _trace()) is None, name
    store(STALE)  # only an earlier run's records
    for name in names:
        assert _read(name, _trace()) is None, name
    store(INDEX)
    for name in names:
        assert _read(name, Trace([], 0.0, 0, [], [])) is None, name
    # a program with no store at all (one that predates the spans)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "seam_match_rcnn_tpu_torch.utils.profiling",
                        types.ModuleType("seam_match_rcnn_tpu_torch.utils.profiling"))
    assert spans.program_records() == []
    for name in names:
        assert _read(name, _trace()) is None, name
