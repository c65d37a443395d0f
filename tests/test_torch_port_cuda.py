"""The CUDA kernels K1-K7 against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips (through the fixture below) when
``torch.cuda.is_available()`` is False.  On the machine with the card, run

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which that machine
does not need).  Inputs are made from a seed with numpy; each comparison
states its tolerance.
"""

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem
from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
from seam_match_rcnn_tpu_torch.ops.roi_align import (fpn_level_indices, multilevel_roi_align,
                                                      multilevel_roi_align_adjoint,
                                                      roi_footprints)
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores
from seam_match_rcnn_tpu_torch.models.match_head import MatchPredictor, TemporalAggregator
from seam_match_rcnn_tpu_torch.train import seam
from seam_match_rcnn_tpu_torch.train.optim import SGD

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("b,h,w,in_dtype,out_dtype", [
    (1, 64, 96, torch.float32, torch.bfloat16), (2, 200, 336, torch.float32, torch.bfloat16),
    # pooled sizes no 8x16 tile divides, both input and both output types
    (1, 68, 100, torch.float32, torch.bfloat16), (1, 68, 100, torch.bfloat16, torch.float32),
    (2, 200, 336, torch.bfloat16, torch.bfloat16), (2, 200, 336, torch.float32, torch.float32),
    (1, 800, 1344, torch.float32, torch.bfloat16), (1, 800, 1344, torch.bfloat16, torch.float32)])
def test_stem_kernel_matches_plain(card, b, h, w, in_dtype, out_dtype):
    rng = np.random.RandomState(h)
    x = torch.from_numpy(rng.randn(b, 3, h, w).astype(np.float32)).to(card, in_dtype)
    cw = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.2).astype(np.float32)).to(card)
    scale = torch.from_numpy((0.5 + rng.rand(64)).astype(np.float32)).to(card)
    shift = torch.from_numpy(rng.randn(64).astype(np.float32)).to(card)
    n0 = cuda_stem.fused_stem.launches
    got = cuda_stem.fused_stem(x, cw, scale, shift, out_dtype)
    torch.cuda.synchronize()
    assert cuda_stem.fused_stem.launches == n0 + 1
    assert got.dtype == out_dtype and got.shape == (b, 64, h // 4, w // 4)
    # an f32 output holds the bf16-rounded value
    assert torch.equal(got, got.to(torch.bfloat16).to(out_dtype))
    want = cuda_stem.stem_plain(x, cw, scale, shift, torch.bfloat16)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    # same bf16 operands, f32 sums in another order: a value may round to
    # the neighbouring bf16 (one ulp), rarely
    err = np.abs(got - want)
    assert np.all(err <= _bf16_ulp(want))
    assert (err > 0).mean() < 1e-3


@pytest.mark.parametrize("dtype,o", [(torch.float32, 7), (torch.float32, 14),
                                     (torch.bfloat16, 7)])
def test_roi_align_kernel_matches_plain(card, dtype, o):
    rng = np.random.RandomState(o)
    b, n, c = 2, 300, 64
    levels = ((96, 120), (48, 60), (24, 30), (12, 15))
    feats = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in levels]
    cx, cy = rng.uniform(-8, 488, (b, n)), rng.uniform(-8, 392, (b, n))
    bw = np.exp(rng.uniform(np.log(0.5), np.log(700), (b, n)))
    bh = bw * np.exp(rng.uniform(np.log(0.2), np.log(5), (b, n)))
    rois = torch.from_numpy(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                                     -1).astype(np.float32)).to(card)
    got = cuda_roi_align.roi_align(feats, rois, o)
    torch.cuda.synchronize()
    want = multilevel_roi_align(feats, rois, o)
    assert got.shape == want.shape == (b * n, c, o, o) and got.dtype == dtype
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        # same geometry arithmetic (the kernel is built without FMA
        # contraction); only the order of the f32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # f32 sums rounded to bf16 once: one bf16 ulp apart at most
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


K5_LEVELS = ((96, 192), (48, 96), (24, 48), (12, 24))  # P2..P5 of a 384x768 canvas


def _k5_rois(rng, b, n, kind):
    if kind == "borders":  # on and beyond the canvas edges, degenerate, tiny
        base = np.asarray([[0, 0, 40, 40], [726, 340, 768, 384], [-20, -20, 30, 30],
                           [740, 0, 790, 384], [0, 370, 768, 400], [100, 100, 100, 100],
                           [0, 0, 2, 2], [0, 0, 768, 384]], np.float32)
        return np.stack([base[rng.permutation(len(base))] for _ in range(b)])
    if kind == "large":
        # 450-760 px sides: P5 (12 x 24 cells here), 2-3 of K5's 8x8-cell
        # tiles along each axis, some beyond the canvas
        x1, y1 = rng.uniform(-60, 300, (b, n)), rng.uniform(-60, 20, (b, n))
        return np.stack([x1, y1, x1 + rng.uniform(520, 760, (b, n)),
                         y1 + rng.uniform(450, 480, (b, n))], -1).astype(np.float32)
    if kind == "wide":
        # slivers that map to P2 (small area) yet span 150-190 cells there:
        # three 64-cell bands, beyond the TPU kernel's 2x2 bands
        x1, y1 = rng.uniform(0, 8, (b, n)), rng.uniform(0, 370, (b, n))
        return np.stack([x1, y1, x1 + rng.uniform(600, 760, (b, n)),
                         y1 + rng.uniform(2, 6, (b, n))], -1).astype(np.float32)
    cx, cy = rng.uniform(-8, 776, (b, n)), rng.uniform(-8, 392, (b, n))
    bw = np.exp(rng.uniform(np.log(2), np.log(600), (b, n)))
    bh = bw * np.exp(rng.uniform(np.log(0.3), np.log(3), (b, n)))
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(np.float32)


def _k2_border_rois(rng):
    """Three images of 9 rois over K5_LEVELS' 384x768 canvas: the border
    class of K5's tests (degenerate, tiny, on and beyond the canvas edges,
    the whole canvas) and one mixed roi; 9 rois that all map to P2; 9 that
    all map to P5.  N = 27 is odd."""
    side = rng.uniform(4, 60, 9)
    x1, y1 = rng.uniform(-10, 760, 9), rng.uniform(-10, 380, 9)
    small = np.stack([x1, y1, x1 + side, y1 + side * rng.uniform(0.5, 2, 9)], -1)
    x1, y1 = rng.uniform(-100, 300, 9), rng.uniform(-100, 50, 9)
    large = np.stack([x1, y1, x1 + rng.uniform(560, 900, 9), y1 + rng.uniform(400, 560, 9)], -1)
    borders = np.concatenate([_k5_rois(rng, 1, 8, "borders")[0], _k5_rois(rng, 1, 1, "mix")[0]])
    return np.stack([borders, small, large]).astype(np.float32)


@pytest.mark.parametrize("dtype,o,c", [(torch.float32, 7, 64), (torch.float32, 14, 36),
                                       (torch.bfloat16, 7, 96), (torch.bfloat16, 14, 8)])
def test_roi_align_kernel_on_border_rois(card, dtype, o, c):
    rng = np.random.RandomState(40 + o + c)
    rois = _k2_border_rois(rng)
    levels = fpn_level_indices(torch.from_numpy(rois))
    assert (levels[1] == 0).all() and (levels[2] == 3).all()
    feats = [torch.from_numpy(rng.randn(3, c, h, w).astype(np.float32)).to(card, dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    rois = torch.from_numpy(rois).to(card)
    n0 = cuda_roi_align.roi_align.launches
    got = cuda_roi_align.roi_align(feats, rois, o)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align.launches == n0 + 1
    want = multilevel_roi_align(feats, rois, o)
    assert got.shape == want.shape == (27, c, o, o) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        # same geometry arithmetic (no FMA contraction on either side); only
        # the order of the f32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # f32 sums rounded to bf16 once: one bf16 ulp, rarely
        err = np.abs(got - want)
        assert np.all(err <= _bf16_ulp(want) + 1e-6) and (err > 0).mean() < 1e-3


@pytest.mark.parametrize("dtype,o,kind,n", [
    (torch.float32, 7, "mix", 200), (torch.float32, 14, "mix", 50),
    (torch.bfloat16, 7, "mix", 200), (torch.bfloat16, 14, "mix", 50),
    (torch.float32, 7, "borders", 8), (torch.float32, 14, "wide", 6),
    (torch.bfloat16, 7, "empty", 0)])
def test_roi_align_adjoint_kernel_matches_plain(card, dtype, o, kind, n):
    rng = np.random.RandomState(o + n)
    b, c = 2, 64
    rois = (_k5_rois(rng, b, n, kind) if kind != "empty"
            else np.zeros((b, 0, 4), np.float32))
    g = torch.from_numpy(rng.randn(b, rois.shape[1], o, o, c).astype(np.float32)).to(card)
    rois = torch.from_numpy(rois).to(card)
    n0 = cuda_roi_align.roi_align_adjoint.launches
    got = cuda_roi_align.roi_align_adjoint(g, rois, K5_LEVELS, dtype)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_adjoint.launches == n0 + (1 if n else 0)
    want = multilevel_roi_align_adjoint(g, rois, K5_LEVELS)
    mass = multilevel_roi_align_adjoint(g.abs(), rois, K5_LEVELS)  # sum of |summands|
    for lv, (a, w, m) in enumerate(zip(got, want, mass)):
        h, wd = K5_LEVELS[lv]
        assert a.shape == (b, c, h, wd) and a.dtype == dtype
        assert a.is_contiguous(memory_format=torch.channels_last)
        a = a.permute(0, 2, 3, 1).float().cpu().numpy()
        w, m = w.cpu().numpy(), m.cpu().numpy()
        # the same f32 summands added in another (fixed) order: |error| <=
        # 1e-5 x the sum of |summands|
        tol = 1e-5 * m + 1e-7
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(w)  # one final rounding to bf16 on each side
        assert np.all(np.abs(a - w) <= tol), f"level {lv}"
    if kind == "empty":
        assert all(float(a.abs().max()) == 0.0 for a in got)


def _k5_check(got, g, rois, dtype):
    """K5's output against the plain adjoint: the same f32 summands added in
    another (fixed) order, |error| <= 1e-5 x the sum of |summands|, plus one
    bf16 ulp for bf16 output."""
    want = multilevel_roi_align_adjoint(g, rois, K5_LEVELS)
    mass = multilevel_roi_align_adjoint(g.abs(), rois, K5_LEVELS)
    for lv, (a, w, m) in enumerate(zip(got, want, mass)):
        a = a.permute(0, 2, 3, 1).float().cpu().numpy()
        w, m = w.cpu().numpy(), m.cpu().numpy()
        tol = 1e-5 * m + 1e-7
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(w)
        assert np.all(np.abs(a - w) <= tol), f"level {lv}"


@pytest.mark.parametrize("branch,o,n,dtype", [("box", 7, 512, torch.bfloat16),
                                              ("mask", 14, 128, torch.bfloat16),
                                              ("box", 7, 512, torch.float32)])
def test_roi_align_adjoint_kernel_is_deterministic(card, branch, o, n, dtype):
    """The training shapes (8 x 512 rois at 7x7, 8 x 128 at 14x14) in small
    form: two calls on the same inputs return the same bytes."""
    rng = np.random.RandomState(60 + o)
    b, c = 2, 64
    rois = torch.from_numpy(_k5_rois(rng, b, n, "mix")).to(card)
    g = torch.from_numpy(rng.randn(b, n, o, o, c).astype(np.float32)).to(card)
    n0 = cuda_roi_align.roi_align_adjoint.launches
    first = cuda_roi_align.roi_align_adjoint(g, rois, K5_LEVELS, dtype)
    second = cuda_roi_align.roi_align_adjoint(g, rois, K5_LEVELS, dtype)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_adjoint.launches == n0 + 2
    for a, z in zip(first, second):
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           z.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    _k5_check(first, g, rois, dtype)


def test_roi_align_patch_backward_is_deterministic(card):
    """The "pallas" step's backward (K6 forward, K5 backward) twice on the
    same inputs: the level gradients are equal bytes."""
    rng = np.random.RandomState(61)
    b, n, c = 2, 60, 64
    base = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    rois = torch.from_numpy(_k6_rois(rng, b, n)).to(card)
    g = torch.from_numpy(rng.randn(b * rois.shape[1], c, 7, 7).astype(np.float32)).to(
        card, torch.bfloat16)
    grads = []
    for _ in range(2):
        feats = [f.clone().requires_grad_(True) for f in base]
        cuda_roi_align.roi_align_patch(feats, rois, 7).backward(g)
        grads.append([f.grad for f in feats])
    torch.cuda.synchronize()
    for a, z in zip(*grads):
        assert torch.equal(a.view(torch.int16), z.view(torch.int16))


@pytest.mark.parametrize("kind,o,n,dtype", [("large", 7, 40, torch.float32),
                                            ("large", 14, 20, torch.bfloat16),
                                            ("wide", 14, 12, torch.float32),
                                            ("wide", 7, 12, torch.bfloat16),
                                            ("borders", 14, 8, torch.bfloat16)])
def test_roi_align_adjoint_kernel_on_multi_tile_footprints(card, kind, o, n, dtype):
    """Rois whose footprint spans many of K5's 8x8-cell tiles: large rois
    on P5, wide slivers on P2 (14x14 bins of wide aspect), rois that clamp
    at the last row and column."""
    rng = np.random.RandomState(70 + o + n)
    b, c = 2, 32
    rois = _k5_rois(rng, b, n, kind)
    lvl, y0, y1, x0, x1 = roi_footprints(torch.from_numpy(rois), K5_LEVELS, o)
    spans = ((y1 // 8 - y0 // 8 + 1) * (x1 // 8 - x0 // 8 + 1))[(y0 <= y1) & (x0 <= x1)]
    assert int(spans.max()) >= 4
    if kind == "large":
        assert (lvl == 3).all()
    rois = torch.from_numpy(rois).to(card)
    g = torch.from_numpy(rng.randn(b, n, o, o, c).astype(np.float32)).to(card)
    n0 = cuda_roi_align.roi_align_adjoint.launches
    got = cuda_roi_align.roi_align_adjoint(g, rois, K5_LEVELS, dtype)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_adjoint.launches == n0 + 1
    _k5_check(got, g, rois, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_adjoint_kernel_writes_zeros_outside_every_footprint(card, dtype):
    """The kernel writes every cell of its output, which the wrapper takes
    from torch.empty: with the allocator's block last filled with NaN, the
    cells outside every roi's footprint are exactly 0 and the rest finite."""
    rng = np.random.RandomState(80)
    b, n, c, o = 2, 30, 64, 7
    rois = _k5_rois(rng, b, n, "mix")
    g = torch.from_numpy(rng.randn(b, n, o, o, c).astype(np.float32)).to(card)
    size = sum(b * h * w * c for h, w in K5_LEVELS)
    torch.full((size,), float("nan"), dtype=dtype, device=card)  # freed at once
    got = cuda_roi_align.roi_align_adjoint(g, torch.from_numpy(rois).to(card), K5_LEVELS, dtype)
    torch.cuda.synchronize()
    lvl, y0, y1, x0, x1 = (v.numpy() for v in roi_footprints(torch.from_numpy(rois),
                                                               K5_LEVELS, o))
    img = np.repeat(np.arange(b), n)
    for level, a in enumerate(got):
        a = a.permute(0, 2, 3, 1).float().cpu().numpy()
        assert np.isfinite(a).all()
        inside = np.zeros(a.shape[:3], bool)
        for i in np.nonzero(lvl == level)[0]:
            inside[img[i], y0[i]:y1[i] + 1, x0[i]:x1[i] + 1] = True
        assert (a[~inside] == 0).all() and (~inside).any()
    _k5_check(got, g, torch.from_numpy(rois).to(card), dtype)


def test_roi_align_function_backward_on_the_card(card):
    rng = np.random.RandomState(7)
    b, n, c = 2, 40, 32
    base = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    rois = torch.from_numpy(_k5_rois(rng, b, n, "mix")).to(card)
    g = torch.from_numpy(rng.randn(b * n, c, 7, 7).astype(np.float32)).to(card, torch.bfloat16)
    feats = [f.clone().requires_grad_(True) for f in base]
    n0, a0 = cuda_roi_align.roi_align.launches, cuda_roi_align.roi_align_adjoint.launches
    out = cuda_roi_align.roi_align(feats, rois, 7)
    out.backward(g)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align.launches == n0 + 1
    assert cuda_roi_align.roi_align_adjoint.launches == a0 + 1
    gf = g.float().permute(0, 2, 3, 1).reshape(b, n, 7, 7, c).contiguous()
    want = multilevel_roi_align_adjoint(gf, rois, K5_LEVELS)
    mass = multilevel_roi_align_adjoint(gf.abs(), rois, K5_LEVELS)
    for f, w, m in zip(feats, want, mass):
        assert f.grad.dtype == torch.bfloat16 and f.grad.shape == f.shape
        a = f.grad.float().permute(0, 2, 3, 1).cpu().numpy()
        w, m = w.cpu().numpy(), m.cpu().numpy()
        assert np.all(np.abs(a - w) <= 1e-5 * m + 1e-7 + _bf16_ulp(w))


def _k6_rois(rng, b, n):
    """The mix of K5's card tests, borders among them, and 4 slivers per
    image that overflow K6's 40x48-cell window at P2."""
    rois = np.concatenate([_k5_rois(rng, b, n, "mix"), _k5_rois(rng, b, 8, "borders"),
                           np.tile(np.asarray([[[100, 40, 162, 230], [400, 100, 462, 290],
                                                 [40, 100, 245, 158], [300, 300, 505, 358]]],
                                              np.float32), (b, 1, 1))], axis=1)
    assert patch.footprint_clamp_mask(torch.from_numpy(rois), K5_LEVELS).sum() >= 4 * b
    return rois


@pytest.mark.parametrize("dtype,o", [(torch.float32, 7), (torch.float32, 14),
                                     (torch.bfloat16, 7), (torch.bfloat16, 14)])
def test_roi_align_patch_kernel_matches_plain(card, dtype, o):
    rng = np.random.RandomState(20 + o)
    b, c = 2, 96
    feats = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    rois = torch.from_numpy(_k6_rois(rng, b, 150)).to(card)
    n0 = cuda_roi_align.roi_align_patch.launches
    got = cuda_roi_align.roi_align_patch(feats, rois, o)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_patch.launches == n0 + 1
    want = patch.roi_align_patch(feats, rois, o)
    assert got.shape == want.shape == (rois.shape[0] * rois.shape[1], c, o, o)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    err = np.abs(got - want)
    if dtype == torch.float32:
        # the same rounded operator entries; only the order of the f32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # exact products, f32 sums rounded to bf16 once: one ulp, rarely
        assert np.all(err <= _bf16_ulp(want)) and (err > 0).mean() < 1e-3


@pytest.mark.parametrize("o,out_dtype", [(7, torch.bfloat16), (14, torch.float32)])
def test_roi_align_patch_int8_kernel_matches_plain(card, o, out_dtype):
    rng = np.random.RandomState(30 + o)
    b, c = 2, 96
    feats = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, torch.bfloat16)
             .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    q, scales = patch.quantize_features_int8(feats)
    assert all(t.is_contiguous(memory_format=torch.channels_last) for t in q)
    rois = torch.from_numpy(_k6_rois(rng, b, 150)).to(card)
    n0 = cuda_roi_align.roi_align_patch_int8.launches
    got = cuda_roi_align.roi_align_patch_int8(q, scales, rois, o, out_dtype)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_patch_int8.launches == n0 + 1
    want = patch.roi_align_patch(q, rois, o, scales=scales, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    # integer sums (exact in any order), the same f32 dequantization: bit-equal
    assert torch.equal(got, want)


def _k6_border_rois(rng, b):
    """Per image, over K5_LEVELS' 384x768 canvas, at each level (square rois
    of side 40, 150, 300 and 520 map to P2..P5): one ending on the canvas's
    last row and column, one reaching beyond them, and one whose window
    starts at column -1 by the 8-aligned rule (first cell 1..6 of its level);
    then the 4 window-overflowing slivers of _k6_rois."""
    out = []
    for _ in range(b):
        rows = []
        for lv, side in enumerate((40.0, 150.0, 300.0, 520.0)):
            s = side * rng.uniform(0.97, 1.03)
            u, y = rng.uniform(1.0, 6.5) * 4 * 2 ** lv, rng.uniform(-20, 384 - s / 2)
            rows += [[768 - s, 384 - s, 768, 384],
                     [768 - s / 2, 384 - s / 2, 768 + s / 2, 384 + s / 2],
                     [u, y, u + s, y + s]]
        out.append(rows + [[100, 40, 162, 230], [400, 100, 462, 290],
                           [40, 100, 245, 158], [300, 300, 505, 358]])
    rois = torch.from_numpy(np.asarray(out, np.float32))
    lvl, y0, x0, _ = patch.patch_geometry(rois.reshape(-1, 4), K5_LEVELS, (0.25, 0.125, 0.0625,
                                                                           0.03125), 7)
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    assert set(lvl[(x0 == -1) & (rois.reshape(-1, 4)[:, 0] > 0)].tolist()) == {0, 1, 2, 3}
    assert patch.footprint_clamp_mask(rois, K5_LEVELS).sum() >= 4 * b
    return rois


@pytest.mark.parametrize("dtype,o,c", [
    (torch.bfloat16, 7, 8), (torch.bfloat16, 14, 64), (torch.bfloat16, 7, 256),
    (torch.float32, 14, 8), (torch.float32, 7, 64), (torch.float32, 14, 256),
    (torch.int8, 7, 64), (torch.int8, 14, 256)])
def test_roi_align_patch_kernels_on_border_rois(card, dtype, o, c):
    """K6 (bf16, f32) and K7 (int8, which takes C a multiple of 16) on rois
    at every level's last row and column, at the 8-aligned window start and
    overflowing the window."""
    rng = np.random.RandomState(50 + o + c)
    rois = _k6_border_rois(rng, 2).to(card)
    base = [torch.from_numpy(rng.randn(2, c, h, w).astype(np.float32)).to(card)
            .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    if dtype == torch.int8:
        q, scales = patch.quantize_features_int8([f.to(torch.bfloat16) for f in base])
        out_dtype = torch.bfloat16 if o == 7 else torch.float32
        n0 = cuda_roi_align.roi_align_patch_int8.launches
        got = cuda_roi_align.roi_align_patch_int8(q, scales, rois, o, out_dtype)
        torch.cuda.synchronize()
        assert cuda_roi_align.roi_align_patch_int8.launches == n0 + 1
        want = patch.roi_align_patch(q, rois, o, scales=scales, out_dtype=out_dtype)
    else:
        feats = [f.to(dtype) for f in base]
        n0 = cuda_roi_align.roi_align_patch.launches
        got = cuda_roi_align.roi_align_patch(feats, rois, o)
        torch.cuda.synchronize()
        assert cuda_roi_align.roi_align_patch.launches == n0 + 1
        want = patch.roi_align_patch(feats, rois, o)
    assert got.shape == want.shape == (rois.shape[0] * rois.shape[1], c, o, o)
    assert got.dtype == want.dtype and got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        # the same rounded operator entries; only the order of the f32 sums differs
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    else:
        # bf16: exact products summed in the plain version's order; int8:
        # integer sums and the same dequantization
        assert torch.equal(got, want)


def test_roi_align_patch_backward_on_the_card(card):
    """The "pallas" backend's autograd: K6 forward, K5 backward (the exact
    adjoint), as the JAX package's pallas_roi_align_trainable."""
    rng = np.random.RandomState(8)
    b, n, c = 2, 40, 32
    base = [torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(card, torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for h, w in K5_LEVELS]
    rois = torch.from_numpy(_k6_rois(rng, b, n)).to(card)
    g = torch.from_numpy(rng.randn(b * rois.shape[1], c, 7, 7).astype(np.float32)).to(
        card, torch.bfloat16)
    feats = [f.clone().requires_grad_(True) for f in base]
    n0, a0 = cuda_roi_align.roi_align_patch.launches, cuda_roi_align.roi_align_adjoint.launches
    out = cuda_roi_align.roi_align_patch(feats, rois, 7)
    out.backward(g)
    torch.cuda.synchronize()
    assert cuda_roi_align.roi_align_patch.launches == n0 + 1
    assert cuda_roi_align.roi_align_adjoint.launches == a0 + 1
    gf = g.float().permute(0, 2, 3, 1).reshape(b, -1, 7, 7, c).contiguous()
    want = multilevel_roi_align_adjoint(gf, rois, K5_LEVELS)
    mass = multilevel_roi_align_adjoint(gf.abs(), rois, K5_LEVELS)
    for f, w, m in zip(feats, want, mass):
        assert f.grad.dtype == torch.bfloat16 and f.grad.shape == f.shape
        a = f.grad.float().permute(0, 2, 3, 1).cpu().numpy()
        w, m = w.cpu().numpy(), m.cpu().numpy()
        assert np.all(np.abs(a - w) <= 1e-5 * m + 1e-7 + _bf16_ulp(w))


@pytest.mark.parametrize("s,t", [(1, 1), (1, 10), (64, 10), (5, 32), (7, 32), (7, 10),
                                 (64, 1), (1, 32)])
def test_nlb_kernel_matches_plain(card, s, t):
    """Ragged tracks, S that fills no multiple of the card, T = 1 and 32;
    with S > 1 a track with no valid frame (count clamped to 1, output 0)
    and, with S > 2, a single-frame one (NLB skipped); one launch a call."""
    rng = np.random.RandomState(s * 100 + t)
    d = lambda i, o: torch.from_numpy((rng.randn(i, o) / np.sqrt(i)).astype(np.float32)).to(card)
    v = lambda o: torch.from_numpy((rng.randn(o) * 0.1).astype(np.float32)).to(card)
    p = {"theta_w": d(256, 128), "theta_b": v(128), "phi_w": d(256, 128), "phi_b": v(128),
         "g_w": d(256, 128), "g_b": v(128), "wcat": v(256), "wz_w": d(128, 256),
         "wz_b": v(256), "att_w": v(256), "att_b": v(1)}
    lengths = rng.randint(1, t + 1, s)
    lengths[-1] = t
    if s > 1:
        lengths[0] = 0
    if s > 2:
        lengths[1] = 1
    mask = torch.from_numpy(np.arange(t)[None] < lengths[:, None]).to(card)
    seqs = torch.from_numpy(rng.randn(s, t, 256).astype(np.float32)).to(card) * mask[..., None]
    n0 = cuda_kernels.nlb_aggregate.launches
    got = cuda_kernels.nlb_aggregate(seqs, mask, p)
    torch.cuda.synchronize()
    assert cuda_kernels.nlb_aggregate.launches == n0 + 1
    want = cuda_kernels.nlb_aggregate_plain(seqs, mask, p)
    if s > 1:
        assert float(got[0].abs().max()) == 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


PAIRWISE_CASES = [
    (1, 16, "near"), (1, 1000, "near"), (1000, 1000, "near"), (77, 130, "near"),
    # each tile the wrapper picks (16 and 64 rows) and both sides of the
    # boundary between them, against ragged galleries
    (1, 67, "exact"), (3, 130, "exact"), (16, 1000, "exact"), (17, 77, "near"),
    (64, 333, "exact"), (65, 1000, "near"), (128, 333, "exact"), (129, 130, "near"),
    (1000, 999, "exact"), (3, 130, "x10"), (65, 1000, "x10"), (1000, 1000, "x10")]


@pytest.mark.parametrize("q,g,kind", [
    pytest.param(q, g, k, id=f"{q}-{g}" if k == "near" else f"{q}-{g}-{k}")
    for q, g, k in PAIRWISE_CASES])
def test_pairwise_kernel_matches_plain(card, q, g, kind):
    rng = np.random.RandomState(q + g)
    x = rng.randn(q, 256).astype(np.float32)
    y = rng.randn(g, 256).astype(np.float32)
    m = min(q, g)
    if kind == "exact":  # x_i == y_j: d = c0 up to the rounding of a + g - 2 cross
        y[:m] = x[:m]
        y[m:2 * m] = x[:min(m, g - m)] + 1e-3 * rng.randn(min(m, g - m), 256)
    else:
        y[:m] = x[:m] + 1e-3 * rng.randn(m, 256)  # near-duplicates
    scale = 10.0 if kind == "x10" else 1.0
    x, y = x * scale, y * scale
    w = (rng.randn(2, 256) * 0.05).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (x, y, w, b)]
    n0 = cuda_kernels.pairwise_scores.launches
    got = cuda_kernels.pairwise_scores(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.pairwise_scores.launches == n0 + 1
    want = pairwise_match_scores(*args)
    # a_i, g_j and the cross term are f32 sums of 256 terms of size |x|^2 |v|
    # whose rounding (in another order on each side) grows with |x|^2: at
    # unit scale 1e-5, at x10 scale 100x that
    tol = 1e-5 * scale ** 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros((1, 3, 62, 64), device=card)
    w = torch.zeros((64, 3, 7, 7), device=card)
    with pytest.raises(ValueError):
        cuda_stem.fused_stem(x, w, torch.ones(64, device=card), torch.zeros(64, device=card),
                             torch.float32)
    feats = [torch.zeros((1, 8, 8, 8), device=card) for _ in range(4)]  # NCHW, not channels_last
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align(feats, torch.zeros((1, 2, 4), device=card), 7)
    with pytest.raises(ValueError):
        cuda_kernels.nlb_aggregate(torch.zeros((1, 33, 256), device=card),
                                   torch.ones((1, 33), device=card), {})
    with pytest.raises(ValueError):  # a bf16 cotangent: the kernel takes f32
        cuda_roi_align.roi_align_adjoint(torch.zeros((1, 2, 7, 7, 8), device=card,
                                                     dtype=torch.bfloat16),
                                         torch.zeros((1, 2, 4), device=card),
                                         K5_LEVELS, torch.float32)
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(ValueError):  # NCHW, not channels_last
        cuda_roi_align.roi_align_patch(feats, rois, 7)
    cl = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    with pytest.raises(ValueError):  # an output larger than the kernel's tap tables
        cuda_roi_align.roi_align_patch(cl, rois, 28)
    q = [f.to(torch.int8) for f in cl]
    with pytest.raises(ValueError):  # int8 levels need their [4, C] scales
        cuda_roi_align.roi_align_patch_int8(q, torch.ones((4, 3), device=card), rois, 7,
                                            torch.float32)
    with pytest.raises(ValueError):  # K7 takes int8 levels only
        cuda_roi_align.roi_align_patch_int8(cl, torch.ones((4, 8), device=card), rois, 7,
                                            torch.float32)
    with pytest.raises(ValueError):  # 8 int8 channels: K7 loads 16 at once
        cuda_roi_align.roi_align_patch_int8(q, torch.ones((4, 8), device=card), rois, 7,
                                            torch.float32)
    with pytest.raises(ValueError):  # K1 takes f32 or bf16 input and output only
        cuda_stem.fused_stem(torch.zeros((1, 3, 64, 64), device=card, dtype=torch.float16), w,
                             torch.ones(64, device=card), torch.zeros(64, device=card),
                             torch.float32)
    with pytest.raises(ValueError):
        cuda_stem.fused_stem(torch.zeros((1, 3, 64, 64), device=card), w,
                             torch.ones(64, device=card), torch.zeros(64, device=card),
                             torch.float16)
    # K2: 16-byte channel vectors, the sample tables, 32-bit indexing, alignment
    cl12 = [torch.zeros((1, 12, 8, 8), device=card, dtype=torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for _ in range(4)]
    with pytest.raises(ValueError):  # 12 bf16 channels: not a multiple of 8
        cuda_roi_align.roi_align(cl12, rois, 7)
    with pytest.raises(ValueError):  # the same for K6
        cuda_roi_align.roi_align_patch(cl12, rois, 7)
    with pytest.raises(ValueError):  # more channels than one block's threads take
        cuda_roi_align.roi_align([torch.zeros((1, 1028, 2, 2), device=card)
                                  .contiguous(memory_format=torch.channels_last)] * 4, rois, 7)
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_patch([torch.zeros((1, 1028, 2, 2), device=card)
                                        .contiguous(memory_format=torch.channels_last)] * 4,
                                       rois, 7)
    with pytest.raises(ValueError):  # 33 x 2 sample coordinates per axis, above 64
        cuda_roi_align.roi_align(cl, rois, 33)
    base = torch.zeros(8 * 8 * 8 + 1, device=card)
    shifted = base[1:].view(1, 8, 8, 8).permute(0, 3, 1, 2)  # channels_last, 4 bytes off
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align([shifted] + cl[1:], rois, 7)
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_patch([shifted] + cl[1:], rois, 7)
    big = torch.empty((1, 8, 16384, 16385), device=card, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)  # H x W x C >= 2^31
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align([big] + [f.to(torch.bfloat16) for f in cl[1:]], rois, 7)
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_patch([big] + [f.to(torch.bfloat16) for f in cl[1:]], rois, 7)
    del big
    # K4: C a multiple of 4, 16-byte aligned operands, the grid's rows
    x6 = torch.zeros((2, 6), device=card)
    with pytest.raises(ValueError):
        cuda_kernels.pairwise_scores(x6, x6, torch.zeros((2, 6), device=card),
                                     torch.zeros(2, device=card))
    x8 = torch.zeros((2, 8), device=card)
    w8 = torch.zeros(17, device=card)[1:].view(2, 8)  # contiguous, 4 bytes off
    with pytest.raises(ValueError):
        cuda_kernels.pairwise_scores(x8, x8, w8, torch.zeros(2, device=card))
    with pytest.raises(ValueError):
        cuda_kernels.pairwise_scores(torch.zeros((cuda_kernels.PAIRWISE_MAX_Q + 1, 4),
                                                 device=card),
                                     torch.zeros((1, 4), device=card),
                                     torch.zeros((2, 4), device=card),
                                     torch.zeros(2, device=card))


def test_nlb_kernel_refuses_a_call_that_needs_its_backward(card):
    """K3 has no backward: with seqs or a weight that requires grad (grad
    mode on) its wrapper raises, launching nothing, instead of returning an
    output cut from the graph; under no_grad the same call launches."""
    rng = np.random.RandomState(12)
    ta = TemporalAggregator(torch.float32, nlb_backend="pallas").to(card)
    seqs = torch.from_numpy(rng.randn(3, 5, 256).astype(np.float32)).to(card)
    mask = torch.ones((3, 5), dtype=torch.bool, device=card)
    n0 = cuda_kernels.nlb_aggregate.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ta.aggregate(seqs, mask)  # the weights are parameters
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_kernels.nlb_aggregate(seqs.clone().requires_grad_(True), mask,
                                   {k: v.detach() for k, v in ta.nlb_weights().items()})
    assert cuda_kernels.nlb_aggregate.launches == n0
    with torch.no_grad():
        served = ta.aggregate(seqs, mask)
    assert cuda_kernels.nlb_aggregate.launches == n0 + 1
    trained = ta.aggregate(seqs, mask, nlb_backend="xla")  # the training path: torch ops
    assert trained.requires_grad
    torch.testing.assert_close(trained.detach(), served, rtol=1e-5, atol=1e-5)


def _seam_heads(rng):
    """Both heads (f32 trunks) with every tensor drawn from ``rng``."""
    mp, ta = MatchPredictor(torch.float32), TemporalAggregator(torch.float32, "pallas")
    with torch.no_grad():
        for mod in (mp, ta):
            for name, t in list(mod.named_parameters()) + list(mod.named_buffers()):
                if name.endswith("running_var"):
                    t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
                elif not name.endswith("num_batches_tracked"):
                    scale = 1.0 / np.sqrt(t[0].numel()) if t.dim() >= 2 else 0.05
                    t.copy_(torch.from_numpy((rng.randn(*t.shape) * scale).astype(np.float32)))
    return mp, ta


def test_seam_head_step_on_the_card_matches_the_cpu(card):
    """One MovingFashion head step (64 rows of 4 products x (1 shop + 4
    frames)) on the card and on the CPU from the same heads and rows: the
    losses within rtol 1e-4, the updates by ``seam.compare_head_updates``
    (each parameter's within 5e-3 of its norm, the BatchNorm statistics
    within rtol 1e-4, atol 1e-5: the rule of the CPU step tests)."""
    import copy

    rng = np.random.RandomState(13)
    n_img, d, p, t = 20, 6, 4, 4
    outs = [{"scores": rng.uniform(0.3, 1.0, d).astype(np.float32), "valid": np.ones(d, bool),
             "boxes": np.concatenate([rng.uniform(0, 50, (d, 2)), rng.uniform(60, 120, (d, 2))],
                                     1).astype(np.float32)} for _ in range(n_img)]
    sel = seam.select_rows_host(outs, [1, 0, 0, 0, 0] * p, [i // 5 for i in range(n_img)], 0.5,
                                p, t, 64)
    batch = {k: torch.from_numpy(getattr(sel, k)) for k in (
        "row_img", "row_det", "valid", "types", "prod", "img_slot", "shop_row")}
    batch["roi_src"] = torch.from_numpy((rng.randn(n_img, d, 256, 14, 14)
                                         + 2.0 * rng.randn(n_img, d, 256, 1, 1)).astype(np.float32))
    batch["aggr_weight"] = torch.tensor(1.0)
    heads = {}
    for dev in ("cpu", card):
        mp, ta = _seam_heads(np.random.RandomState(14))
        mp, ta = mp.to(dev), ta.to(dev)
        before = [copy.deepcopy(m.state_dict()) for m in (mp, ta)]
        opt = SGD(list(mp.parameters()) + list(ta.parameters()), lambda s: 0.002, 0.9, 5e-4)
        step = seam.make_seam_head_step(mp, ta, opt, frames_per_product=t)
        losses = step({k: v.to(dev) for k, v in batch.items()})
        heads[str(dev)] = (losses, before, [m.state_dict() for m in (mp, ta)])
    (cpu_l, cpu_b, cpu_a), (gpu_l, _, gpu_a) = heads["cpu"], heads[str(card)]
    for k in cpu_l:
        assert float(gpu_l[k]) == pytest.approx(float(cpu_l[k]), rel=1e-4), k
    def both(sds):
        return {f"{name}.{k}": v for name, sd in zip(("mp", "ta"), sds) for k, v in sd.items()}

    bad, _ = seam.compare_head_updates(both(cpu_b), both(cpu_a), both(gpu_a))
    assert not bad, bad
