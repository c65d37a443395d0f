"""The per-layer readers give known values on a synthetic trace."""

import pytest

from portbench import peaks
from portbench import run as R
from portbench.rooflines import k1, k2, k5
from portbench.trace import Op, Trace

MS = 1_000_000  # ns


def _trace():
    host = [
        Op("portbench.item", 0, 100 * MS, [], [], [], 1),
        Op("seam::fused_stem", 1 * MS, 2 * MS, [[2, 3, 64, 128], [64, 3, 7, 7], [64], [64], []],
           ["float", "float", "float", "float", "Scalar"], [None, None, None, None, 15], 1),
        Op("seam::roi_align", 3 * MS, 4 * MS, [[], [2, 10, 4], [], [], []],
           ["TensorList", "float", "Scalar", "Scalar", "ScalarList"],
           [None, None, 7, 2, [0.25, 0.125, 0.0625, 0.03125]], 1),
        Op("aten::item", 60 * MS, 90 * MS, [], [], [], 1),
    ]
    device = [
        Op("void stem_kernel<float, __nv_bfloat16>(...)", 10 * MS, 12 * MS, [], [], [], 0),
        Op("void roi_align_kernel<__nv_bfloat16>(...)", 20 * MS, 24 * MS, [], [], [], 0),
        Op("roi_adjoint_kernel(...)", 30 * MS, 31 * MS, [], [], [], 0),
        Op("Memcpy HtoD (Pageable -> Device)", 40 * MS, 50 * MS, [], [], [], 0),
        Op("Memcpy HtoD (Pageable -> Device)", 45 * MS, 55 * MS, [], [], [], 0),
    ]
    # the same records serve as both phases here: a 0.1 s window of 4 units
    t = Trace(device, 0.1, 4, host, device, (0, 100 * MS), rate=40.0)
    t._flops = {"bfloat16": 1e12, "float32": 1e11}
    return t


def test_idle_and_copies():
    t = _trace()
    # busy: 2 + 4 + 1 + (40..55) 15 = 22 ms of 100
    assert R.reader("idle_pct.index").read(t, None) == pytest.approx(78.0)
    assert R.reader("h2d_ms.index").read(t, None) == pytest.approx(20.0 / 4)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["aten::item", pytest.approx(0.045)]  # 55..100 ms, inside aten::item


def test_mfu():
    least = 1e12 / peaks.FLOPS_PER_S["bfloat16"] + 1e11 / peaks.FLOPS_PER_S["float32"]
    assert R.reader("mfu.train").read(_trace(), None) == pytest.approx(100 * least * 40.0)


def test_rooflines():
    t = _trace()
    f, b = k1.count(2, 64, 128, 4, 2)
    assert R.reader("k1_roofline.index").read(t, None) == pytest.approx(
        100 * peaks.bound_s(f, b) / 2e-3)
    f, b = k2.count(2, 10, 7, 2, (64, 128))
    assert R.reader("k2_roofline.index").read(t, None) == pytest.approx(
        100 * peaks.bound_s(f, b) / 4e-3)
    f, b = k5.count(2, 10, 7, 2, (64, 128))
    assert R.reader("k5_roofline.train").read(t, None) == pytest.approx(
        100 * peaks.bound_s(f, b) / 1e-3)


def test_nothing_to_read():
    t = Trace([], 0.1, 0, [], [])
    for name in ("idle_pct.index", "h2d_ms.index", "mfu.index", "k1_roofline.index",
                 "k2_roofline.train", "k5_roofline.train"):
        assert R.reader(name).read(t, None) is None
