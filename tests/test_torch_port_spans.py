"""The program's spans and counters (``utils/profiling``) on the CPU.

A tiny model's ``InferenceRunner`` call and a ``Phase1Trainer`` step (its
batches from ``engine.bucket_batches``) record nothing without a profiler;
under a CPU ``torch.profiler`` they record exactly the spans and counters
the benchmark's idle split reads, nested as the code nests them, on the
profiler's own clock.  Also: the store's cap, a guarded span's cost, and
no record while ``torch.export`` traces.  On the card (``-m cuda``): a
kernel's CUPTI record lies inside the span that launched and synchronised
it, and a CUDA-only profile (the benchmark's device phase) records the
spans in the store but no ``seam.*`` event of its own."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu_torch.config import (ModelConfig, RoIHeadsConfig, RPNConfig,
                                              TransformConfig)
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.train.engine import bucket_batches
from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer
from seam_match_rcnn_tpu_torch.utils import profiling
from seam_match_rcnn_tpu_torch.utils.profiling import Count, Span

torch.set_num_threads(2)

Canvas64x96 = dataclasses.dataclass(frozen=True)(type("Canvas64x96", (TransformConfig,), {
    "landscape_canvas": property(lambda self: (64, 96)),
    "portrait_canvas": property(lambda self: (96, 64))}))
SIZES = [(40, 60), (60, 40), (44, 66)]  # two canvas buckets

SPANS = {"index": {"seam.call", "seam.ingest", "seam.forward", "seam.nms", "seam.readback"},
         "train": {"seam.ingest", "seam.step", "seam.forward", "seam.nms", "seam.backward",
                   "seam.optimizer"}}
COUNTERS = {"nms.calls", "nms.steps", "bn.plain"}  # K8 applies no FrozenBN on the CPU


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_train=80, post_nms_top_n_train=80,
                      pre_nms_top_n_test=60, post_nms_top_n_test=60, batch_size_per_image=32),
        roi_heads=RoIHeadsConfig(batch_size_per_image=32, detections_per_img=8,
                                 roi_align_backend="pallas_resident"),
        transform=Canvas64x96(min_size=48, max_size=64), compute_dtype="float32",
        stem_backend="pallas", freeze_backbone_stages=True)
    return init_model(cfg, video=True, device="cpu", seed=1)


def _target(rng, h, w, g=2):
    x1, y1 = rng.uniform(0, w / 2, g), rng.uniform(0, h / 2, g)
    bw, bh = rng.uniform(8, w / 2, g), rng.uniform(8, h / 2, g)
    return {"boxes": np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32),
            "labels": rng.randint(1, 14, g), "pair_ids": np.asarray([1, 2]),
            "styles": np.asarray([1, 1]), "sources": np.asarray([0, 1]),
            "mask_crops": (rng.rand(g, 56, 56) > 0.5).astype(np.uint8)}


def _index(model):
    rng = np.random.RandomState(0)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in SIZES]
    return lambda: InferenceRunner(model, chunk=2)(images)


def _train(model):
    rng = np.random.RandomState(1)
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in SIZES]
    targets = [_target(rng, h, w) for h, w in SIZES]
    trainer = Phase1Trainer(model, sgd(model, multistep_warmup_schedule(
        0.002, (6, 9), 0.1, 1000, 1000, 1e-3)))
    generator = torch.Generator().manual_seed(0)

    def step():
        trainer.step(bucket_batches(model, images, targets, 24, "cpu"), generator)

    return step


CALLS = {"index": _index, "train": _train}


def _profiled(fn):
    """Run ``fn`` under a CPU profiler -> (the store's records, kineto events)."""
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    recs = profiling.records()
    profiling.clear()
    return recs, prof.profiler.kineto_results.events()


@pytest.mark.parametrize("kind", ["index", "train"])
def test_no_profiler_records_nothing(model, kind):
    call = CALLS[kind](model)
    profiling.clear()
    call()
    with profiling.annotate("seam.probe"):
        profiling.count("probe.count", 3)
    assert profiling.records() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("kind", ["index", "train"])
def test_profiled_call_records_its_spans_nested(model, kind):
    recs, _ = _profiled(CALLS[kind](model))
    spans = [r for r in recs if isinstance(r, Span)]
    counts = [r for r in recs if isinstance(r, Count)]
    assert {s.name for s in spans} == SPANS[kind]
    assert {c.name for c in counts} == COUNTERS
    root = "seam.call" if kind == "index" else "seam.step"
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots].count(root) == 1
    by_item = {s.item: s for s in roots}
    assert len(by_item) == len(roots)  # each root starts its own item
    inner = [s for s in spans if s.parent is not None]
    for s in inner:
        top = by_item[s.item]
        assert top.name == root and top.t0_ns <= s.t0_ns <= s.t1_ns <= top.t1_ns
        # the parent: the innermost span of that name around it
        around = [p for p in spans if p.name == s.parent and p.item == s.item
                  and p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns]
        assert around, s
    assert {s.parent for s in spans if s.name == "seam.nms"} == {"seam.forward"}
    root_item = next(s.item for s in roots if s.name == root)
    assert all(c.item == root_item for c in counts)
    calls = sum(c.n for c in counts if c.name == "nms.calls")
    steps = sum(c.n for c in counts if c.name == "nms.steps")
    assert steps >= calls >= 1
    if kind == "train":  # bucket_batches runs before the step: a root of its own
        assert [s.parent for s in spans if s.name == "seam.ingest"] == [None]
        assert {s.parent for s in spans if s.name in ("seam.forward", "seam.backward",
                                                      "seam.optimizer")} == {"seam.step"}
    else:
        assert {s.parent for s in spans if s.name != root} == {root, "seam.forward"}


def test_spans_share_the_profiler_clock(model):
    """Each span's [t0_ns, t1_ns] holds the profiler's own range of it and so
    every op recorded inside that range."""
    recs, events = _profiled(CALLS["index"](model))
    spans = [r for r in recs if isinstance(r, Span)]
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    ranges = {}
    for e in cpu:
        if e.name().startswith("seam."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert set(ranges) == {s.name for s in spans}
    for name, rs in ranges.items():
        mine = sorted((s.t0_ns, s.t1_ns) for s in spans if s.name == name)
        assert len(mine) == len(rs)
        for (t0, t1), (s, e) in zip(mine, sorted(rs)):
            assert t0 <= s <= e <= t1
            inside = [o for o in cpu if s <= o.start_ns() and o.end_ns() <= e
                      and o.name().startswith("aten::")]
            assert inside and all(t0 <= o.start_ns() and o.end_ns() <= t1 for o in inside)


def test_store_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_store", profiling.Store(cap=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.annotate(f"seam.probe{i}"):
                pass
        profiling.count("probe.count", 7)
    recs = profiling.records()
    assert [r.name for r in recs] == ["seam.probe3", "seam.probe4", "probe.count"]
    assert profiling.dropped() == 3
    assert recs[-1].n == 7 and recs[-1].item is None  # a count outside any span
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_guarded_span_costs_under_a_microsecond():
    n = 10000
    best = float("inf")
    for _ in range(10):
        t = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("seam.probe"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 1e-6, f"{best * 1e6:.3f} us a span"
    assert profiling.records() == []


def test_export_traces_no_span_even_under_a_profiler():
    class Probe(torch.nn.Module):
        def forward(self, x):
            with profiling.annotate("seam.probe"):
                profiling.count("probe.count")
                return x * 2

    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = torch.export.export(Probe(), (torch.ones(3),), strict=False)
    assert profiling.records() == []
    assert "record_function" not in str(program.graph)


@pytest.mark.cuda
@pytest.mark.parametrize("with_cpu", [True, False], ids=["cpu_and_cuda", "cuda_only"])
def test_kernels_lie_inside_their_span_on_the_card(with_cpu):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2048, 2048, device="cuda")
    x @ x  # cuBLAS's first call outside the profile
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if with_cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    profiling.clear()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with profiling.annotate("seam.probe"):
                x @ x
                torch.cuda.synchronize()
    spans = [r for r in profiling.records() if isinstance(r, Span)]
    profiling.clear()
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU
               and not e.is_user_annotation()]
    assert [s.name for s in spans] == ["seam.probe"] * 3 and len(kernels) >= 3
    # On the H100 of PERF.md §6 this holds in most profiler sessions but not all: there the
    # CUPTI records drift against time.time_ns() by up to a few hundred us over a 1.5 s
    # session, and a few short sessions put a kernel up to 0.17 ms before its span.
    slack = 20_000  # ns
    for k in kernels:
        assert any(s.t0_ns - slack <= k.start_ns() and k.end_ns() <= s.t1_ns + slack
                   for s in spans), (k.name(), k.start_ns(), [(s.t0_ns, s.t1_ns) for s in spans])
    if not with_cpu:
        assert not [e.name() for e in events if e.name().startswith("seam.")]
