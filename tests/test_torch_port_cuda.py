"""The CUDA kernels K1-K5 against their plain PyTorch versions, on the card.

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
from seam_match_rcnn_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                                      multilevel_roi_align_adjoint)
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores

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


@pytest.mark.parametrize("b,h,w", [(1, 64, 96), (2, 200, 336)])
def test_stem_kernel_matches_plain(card, b, h, w):
    rng = np.random.RandomState(h)
    x = torch.from_numpy(rng.randn(b, 3, h, w).astype(np.float32)).to(card)
    cw = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.2).astype(np.float32)).to(card)
    scale = torch.from_numpy((0.5 + rng.rand(64)).astype(np.float32)).to(card)
    shift = torch.from_numpy(rng.randn(64).astype(np.float32)).to(card)
    n0 = cuda_stem.fused_stem.launches
    got = cuda_stem.fused_stem(x, cw, scale, shift, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_stem.fused_stem.launches == n0 + 1
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
        # the same f32 summands added in another order (atomics, which
        # reorder from run to run): |error| <= 1e-5 x the sum of |summands|
        tol = 1e-5 * m + 1e-7
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(w)  # one final rounding to bf16 on each side
        assert np.all(np.abs(a - w) <= tol), f"level {lv}"
    if kind == "empty":
        assert all(float(a.abs().max()) == 0.0 for a in got)


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


@pytest.mark.parametrize("s,t", [(1, 1), (1, 10), (64, 10), (5, 32)])
def test_nlb_kernel_matches_plain(card, s, t):
    rng = np.random.RandomState(s * 100 + t)
    d = lambda i, o: torch.from_numpy((rng.randn(i, o) / np.sqrt(i)).astype(np.float32)).to(card)
    v = lambda o: torch.from_numpy((rng.randn(o) * 0.1).astype(np.float32)).to(card)
    p = {"theta_w": d(256, 128), "theta_b": v(128), "phi_w": d(256, 128), "phi_b": v(128),
         "g_w": d(256, 128), "g_b": v(128), "wcat": v(256), "wz_w": d(128, 256),
         "wz_b": v(256), "att_w": v(256), "att_b": v(1)}
    lengths = rng.randint(1, t + 1, s)
    mask = torch.from_numpy(np.arange(t)[None] < lengths[:, None]).to(card)
    seqs = torch.from_numpy(rng.randn(s, t, 256).astype(np.float32)).to(card) * mask[..., None]
    got = cuda_kernels.nlb_aggregate(seqs, mask, p)
    torch.cuda.synchronize()
    want = cuda_kernels.nlb_aggregate_plain(seqs, mask, p)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q,g", [(1, 16), (1, 1000), (1000, 1000), (77, 130)])
def test_pairwise_kernel_matches_plain(card, q, g):
    rng = np.random.RandomState(q + g)
    x = rng.randn(q, 256).astype(np.float32)
    y = rng.randn(g, 256).astype(np.float32)
    y[: min(q, g)] = x[: min(q, g)] + 1e-3 * rng.randn(min(q, g), 256)  # near-duplicates
    w = (rng.randn(2, 256) * 0.05).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (x, y, w, b)]
    got = cuda_kernels.pairwise_scores(*args)
    torch.cuda.synchronize()
    want = pairwise_match_scores(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


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
