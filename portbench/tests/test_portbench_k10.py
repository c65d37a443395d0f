"""The two readers of kernel K10 on synthetic records: ``ln_fused_pct.vit``
reads 100, 0 and None; ``k10_roofline.vit`` sums ``rooflines/k10.py``'s bounds
over the op's recorded shapes and reads None where launches and kernel records
disagree in number; K10's byte count matches a hand count."""

import pytest

from portbench import peaks, spans
from portbench import run as R
from portbench.rooflines import k10
from portbench.trace import Op, Trace
from seam_match_rcnn_tpu_torch.utils.profiling import Count, Span

MS = 1_000_000  # ns
CELL_X = [11, 64, 64, 1024]  # the index_vit chunk's stream


def test_k10_counts_by_hand():
    rows, c = 11 * 64 * 64, 1024
    f, b = k10.count(rows, c, branch_elem=2, y_elem=2)
    # x read (f32), branch read (bf16), x_new written (f32), y written (bf16), w and b
    assert b == rows * c * (4 + 2 + 4 + 2) + 2 * c * 4 == 553_656_320
    assert f == rows * c * 9
    f, b = k10.count(rows, c, branch_elem=0, y_elem=2)  # the first block's norm1
    assert b == rows * c * (4 + 2) + 2 * c * 4 and f == rows * c * 8
    _, b = k10.count(3, 520, branch_elem=4, y_elem=4)  # an f32 compute dtype
    assert b == 3 * 520 * 16 + 2 * 520 * 4


def _trace(recs, monkeypatch, n_kernels):
    """A device phase busy 10-60 ms of 100 with one forward's counters inside
    a ``seam.call``; the host phase records two K10 calls (one with a bf16
    branch, one without) and ``n_kernels`` kernel records of 0.25 ms each."""
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    device = [Op("kernel", 10 * MS, 60 * MS, [], [], [], 0)]
    host = [Op(k10.OP, 1 * MS, 1 * MS + 1, [CELL_X, CELL_X, [1024], [1024], [], []],
               ["float", "c10::BFloat16", "float", "float", "Scalar", "Scalar"],
               [None, None, None, None, 1e-6, 15], 1),
            Op(k10.OP, 2 * MS, 2 * MS + 1, [CELL_X, [], [1024], [1024], [], []],
               ["float", "", "float", "float", "Scalar", "Scalar"],
               [None, None, None, None, 1e-6, 15], 1)]
    launched = [Op("void (anonymous namespace)::vit_residual_ln_kernel<__nv_bfloat16, 4, "
                   "true>(float const*)", (40 + i) * MS, (40 + i) * MS + MS // 4, [], [], [], 0)
                for i in range(n_kernels)]
    return Trace(device, 0.1, 4, host, launched, (200 * MS, 300 * MS))


def _span(name, t0, t1):
    return Span(name, int(t0 * MS), int(t1 * MS), None, 1, 1)


def test_readers_on_synthetic_records(monkeypatch):
    recs = [_span("seam.call", 0, 100), Count("vit.ln.fused", 31 * MS, 48, 1, 1)]
    t = _trace(recs, monkeypatch, 2)
    read = lambda name: R.reader(name).read(t, None)  # noqa: E731
    assert read("ln_fused_pct.vit") == pytest.approx(100.0)
    rows = 11 * 64 * 64
    least = (peaks.bound_s(*k10.count(rows, 1024, 2, 2))
             + peaks.bound_s(*k10.count(rows, 1024, 0, 2)))
    assert read("k10_roofline.vit") == pytest.approx(100 * least / 0.5e-3)
    # a launch without a kernel record (or one more record) reads nothing
    assert R.reader("k10_roofline.vit").read(_trace(recs, monkeypatch, 1), None) is None
    assert R.reader("k10_roofline.vit").read(_trace(recs, monkeypatch, 3), None) is None


def test_ln_fused_pct_reads_zero_and_none(monkeypatch):
    recs = [_span("seam.call", 0, 100), Count("vit.ln.plain", 31 * MS, 48, 1, 1)]
    t = _trace(recs, monkeypatch, 2)
    assert R.reader("ln_fused_pct.vit").read(t, None) == pytest.approx(0.0)
    # a program that counts neither (the parent, or another backbone)
    t = _trace([_span("seam.call", 0, 100)], monkeypatch, 0)
    assert R.reader("ln_fused_pct.vit").read(t, None) is None
    assert R.reader("k10_roofline.vit").read(t, None) is None
