"""The ViTDet-L indexing cell at a tiny size on the CPU: its entry drives the
port's own ViTDet model and the comparison reads ``correct``; its set-up
refuses a program whose backbone is not the ViTDet; the three readers it adds
give hand-computed values on synthetic records; K9's counts match a hand
count."""

import copy
import dataclasses

import pytest

from portbench import generate, peaks
from portbench import model as M
from portbench import run as R
from portbench import spans
from portbench.entries import index_vitdet
from portbench.rooflines import k9
from portbench.trace import Op, Trace
from seam_match_rcnn_tpu_torch.utils.profiling import Count, Span

CELL = "seam_vitdet_l.index_vit"
BENCH = R.load_benchmark()
MS = 1_000_000  # ns
TINY_VIT = dict(img_size=128, embed_dim=64, depth=4, num_heads=4, window_size=3,
                window_block_indexes=[0, 1, 2], pretrain_img_size=64)


def tiny_config(compute_dtype="float32") -> dict:
    """The configuration at a 128 x 128 canvas, a ViT of 64 channels, 4 heads
    and 4 blocks (block 3 global), few proposals and detections."""
    c = copy.deepcopy(M.load_config("seam_vitdet_l"))
    m = c["model"]
    m["vit"].update(TINY_VIT)
    m["transform"].update(min_size=128, max_size=128, square_pad=128)
    m["rpn"].update(pre_nms_top_n_test=60, post_nms_top_n_test=120)
    m["roi_heads"].update(detections_per_img=6)
    m["compute_dtype"] = compute_dtype
    return c


def tiny_mix() -> dict:
    m = generate.load_mix("index_vit")
    return dict(m, calls=2, products_per_call=2, frames_per_product=2, frame_hw=[48, 80],
                shop_side=[40, 90], check_images=3, trace_items=1)


def test_sound_run_is_correct():
    entry = index_vitdet.Entry(tiny_config(), tiny_mix(), 2**33 + 3, "cpu")
    res = R.run_cell(BENCH, R.find_cell(BENCH, CELL), 2**33 + 3, 0.2, False, device="cpu",
                     entry=entry, log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"score_gap", "box_miss", "match_gap", "aggr_gap", "trunk_gap"}
    flops = entry.flops_per_unit()
    assert flops["bfloat16"] > 0 and flops["float32"] > 0


def test_setup_refuses_another_backbone(monkeypatch):
    """A program that builds its ResNet-50 for this configuration (as one that
    drops the ``backbone`` key would) fails before any weight is drawn."""
    port_config = M.port_config
    monkeypatch.setattr(M, "port_config", lambda cfg, transform=None: dataclasses.replace(
        port_config(cfg, transform), backbone="resnet50_fpn"))
    entry = index_vitdet.Entry(tiny_config(), tiny_mix(), 1, "cpu")
    with pytest.raises(RuntimeError, match="vitdet_l"):
        entry.setup()
    assert not hasattr(entry, "model")


def test_k9_counts_by_hand():
    # a windowed call: 2 images, a 70 x 70 grid of 25 windows of 14 x 14, 16 heads of 64
    f, b = k9.count(2, 70, 70, 3072, 50, 16, 196, 14)
    assert f == 4 * 50 * 16 * 196 * 196 * 64 + 5 * 50 * 16 * 196 * 196
    assert b == 2 * 4900 * 3072 * 2 + 2 * 50 * 16 * 196 * 14 * 2 + 2 * 4900 * 1024 * 2
    # a global call with f32 rel terms
    f, b = k9.count(1, 64, 64, 3072, 1, 16, 4096, 64, rel_elem=4)
    assert f == 16 * 4096 * 4096 * (4 * 64 + 5)
    assert b == 4096 * 3072 * 2 + 2 * 16 * 4096 * 64 * 4 + 4096 * 1024 * 2


def _span(name, t0, t1, parent, item):
    return Span(name, int(t0 * MS), int(t1 * MS), parent, item, 1)


def test_readers_on_synthetic_records(monkeypatch):
    """Device busy 10-20 and 32-60 ms of a 100 ms phase; ``seam.vit`` open
    30-60 (idle 30-32), inside ``seam.forward`` 25-70; one forward counted 24
    fused attention calls; two K9 launches of 1 ms each."""
    recs = [_span("seam.vit", 30, 60, "seam.forward", 1),
            _span("seam.forward", 25, 70, "seam.call", 1),
            _span("seam.call", 0, 100, None, 1),
            Count("vit.attn.fused", 31 * MS, 24, 1, 1), Count("vit.windows", 31 * MS, 504, 1, 1)]
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    device = [Op("kernel", 10 * MS, 20 * MS, [], [], [], 0),
              Op("kernel", 32 * MS, 60 * MS, [], [], [], 0)]
    calls = [([1, 70, 70, 3072], [25, 16, 196, 14], 14), ([1, 64, 64, 3072], [1, 16, 4096, 64], 64)]
    host = [Op(k9.OP, i * MS, i * MS + 1, [qkv, rel, rel, []],
               ["c10::BFloat16"] * 3 + ["Scalar"], [None, None, None, s], 1)
            for i, (qkv, rel, s) in enumerate(calls)]
    launched = [Op("vit_attention_kernel", 40 * MS, 41 * MS, [], [], [], 0),
                Op("vit_attention_kernel", 42 * MS, 43 * MS, [], [], [], 0)]
    t = Trace(device, 0.1, 4, host, launched, (200 * MS, 300 * MS))
    read = lambda name: R.reader(name).read(t, None)  # noqa: E731
    assert read("vit_idle_pct.vit") == pytest.approx(2.0)
    assert read("attn_fused_pct.vit") == pytest.approx(100.0)
    least = sum(peaks.bound_s(*k9.count(q[0], q[1], q[2], q[3], r[0], r[1], r[2], r[3]))
                for q, r, _ in calls)
    assert read("k9_roofline.vit") == pytest.approx(100 * least / 2e-3)
    recs.append(Count("vit.attn.plain", 32 * MS, 24, 1, 1))
    assert read("attn_fused_pct.vit") == pytest.approx(50.0)
    monkeypatch.setattr(spans, "program_records", lambda: [])
    assert read("vit_idle_pct.vit") is None and read("attn_fused_pct.vit") is None
