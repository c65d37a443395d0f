"""Kernel K5's plain version (the exact RoIAlign adjoint) and the autograd
pairing of K2 and K5, on the CPU, against the JAX package.

Inputs are made from a seed with numpy and handed to both sides.  On CPU
tensors the wrappers run their plain versions and leave their launch
counters at 0; the CUDA kernel itself is checked against the plain version
on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.ops.pallas_roi_adjoint import multilevel_roi_align_adjoint_pallas
from seam_match_rcnn_tpu.ops.roi_align import multilevel_roi_align_adjoint as jax_adjoint

from seam_match_rcnn_tpu_torch.ops import cuda_roi_align, cuda_stem
from seam_match_rcnn_tpu_torch.ops.cuda_roi_align import RoIAlignFunction, roi_align
from seam_match_rcnn_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                                      multilevel_roi_align_adjoint,
                                                      roi_footprints)

torch.set_num_threads(2)

# the shapes and rois of tests/test_pallas_roi_adjoint.py: P2..P5 of a
# 256x384 canvas, 8 channels
SHAPES = ((64, 96), (32, 48), (16, 24), (8, 12))
C = 8
BORDER_ROIS = np.asarray([[
    [200.0, 220.0, 320.0, 300.0],   # P2 footprint crossing a 64-cell band
    [0.0, 0.0, 40.0, 40.0],         # top-left corner
    [340.0, 210.0, 383.0, 255.0],   # bottom-right corner
    [0.0, 0.0, 2.0, 2.0],           # tiny (unit roi after the floor)
    [100.0, 100.0, 100.0, 100.0],   # zero area
    [250.0, 60.0, 260.0, 256.0],    # tall sliver
    [60.0, 120.0, 383.0, 160.0],    # wide sliver
    [0.0, 250.0, 380.0, 256.0],     # bottom edge, wide
]], np.float32)


def mix_rois(rng, b, n, canvas=(256, 384)):
    s = rng.uniform(8, 300, (b, n))
    ar = rng.choice([0.5, 1.0, 2.0], (b, n))
    w, h = s * np.sqrt(ar), s / np.sqrt(ar)
    x1 = rng.uniform(0, canvas[1] - np.minimum(w, canvas[1] - 1))
    y1 = rng.uniform(0, canvas[0] - np.minimum(h, canvas[0] - 1))
    return np.stack([x1, y1, np.minimum(x1 + w, canvas[1]), np.minimum(y1 + h, canvas[0])],
                    -1).astype(np.float32)


def _case(name):
    rng = np.random.RandomState({"mix7": 0, "mix14": 1, "borders": 2}[name])
    if name == "borders":
        rois, out = BORDER_ROIS, 7
    else:
        out = 7 if name == "mix7" else 14
        rois = mix_rois(rng, 2, 24 if out == 7 else 10)
    g = rng.randn(*rois.shape[:2], out, out, C).astype(np.float32)
    return g, rois, out


def _port_adjoint(g, rois):
    return [a.numpy() for a in multilevel_roi_align_adjoint(
        torch.from_numpy(g), torch.from_numpy(rois), SHAPES)]


@pytest.mark.parametrize("name", ["mix7", "mix14", "borders"])
def test_k5_plain_matches_jax_exact_adjoint(name):
    g, rois, out = _case(name)
    # op by op: jitted, XLA contracts the sample geometry into FMAs, which
    # moves a coordinate one f32 ulp away from the separately rounded ops
    # of the port (and of its kernel, built with -fmad=false)
    with jax.disable_jit():
        want = [np.stack(lv) for lv in zip(*[
            [np.asarray(a) for a in jax_adjoint(jnp.asarray(g[i]), SHAPES, jnp.asarray(rois[i]),
                                                out)]
            for i in range(rois.shape[0])])]
    got = _port_adjoint(g, rois)
    for lv, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (rois.shape[0],) + SHAPES[lv] + (C,)
        # the same summands, both accumulated in f32 by a sequential CPU
        # scatter-add; the order of the additions may differ
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"level {lv}")


@pytest.mark.parametrize("name", ["mix7", "mix14", "borders"])
def test_k5_plain_matches_pallas_adjoint_kernel(name):
    """Against the TPU kernel in interpret mode, full precision, on rois
    inside its 2x2-band contract: its tolerance there is that of
    tests/test_pallas_roi_adjoint.py (same summands, another f32 order)."""
    g, rois, out = _case(name)
    want = multilevel_roi_align_adjoint_pallas(jnp.asarray(g), jnp.asarray(rois), SHAPES, out,
                                               interpret=True, highest=True)
    got = _port_adjoint(g, rois)
    for lv, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=2e-5 * max(1.0, np.abs(b).max()),
                                   err_msg=f"level {lv}")


# on and beyond the 256x384 canvas's edges, at every level: K5's footprint
# rule clamps these at -1 and at the level's size
EDGE_ROIS = np.asarray([[
    [-30.0, -20.0, 20.0, 25.0], [360.0, 230.0, 400.0, 270.0], [370.0, 0.0, 384.0, 256.0],
    [0.0, 250.0, 384.0, 256.0], [-500.0, -400.0, -300.0, -200.0], [384.0, 256.0, 900.0, 700.0],
    [-100.0, 100.0, 500.0, 140.0], [200.0, -300.0, 230.0, 600.0], [0.0, 0.0, 384.0, 256.0],
    [300.0, 180.0, 700.0, 500.0], [383.0, 255.0, 384.0, 256.0], [-1.0, -1.0, 0.0, 0.0],
]], np.float32)


@pytest.mark.parametrize("name", ["mix7", "mix14", "borders", "edges"])
def test_k5_footprints_hold_every_touched_cell(name):
    """K5 picks a tile's rois by their footprints (``roi_footprints``, the
    plain twin of the kernel's rule): every cell to which the plain adjoint
    adds a non-zero summand of a roi lies in that roi's footprint on its
    level.  A cotangent of ones makes every summand >= 0, so the roi's
    non-zero cells are exactly those with a non-zero summand."""
    if name == "edges":
        rois, out = EDGE_ROIS, 14
    else:
        _, rois, out = _case(name)
    lvl, y0, y1, x0, x1 = roi_footprints(torch.from_numpy(rois), SHAPES, out)
    flat = torch.from_numpy(rois).reshape(1, -1, 4)
    touched = 0
    for i in range(flat.shape[1]):
        adj = multilevel_roi_align_adjoint(torch.ones((1, 1, out, out, 1)), flat[:, i:i + 1],
                                           SHAPES)
        for level, a in enumerate(adj):
            ys, xs = np.nonzero(a[0, :, :, 0].numpy())
            if level != int(lvl[i]):
                assert len(ys) == 0, f"roi {i} touches level {level}, not its own"
                continue
            touched += len(ys) > 0
            assert ((ys >= int(y0[i])) & (ys <= int(y1[i])) & (xs >= int(x0[i]))
                    & (xs <= int(x1[i]))).all(), f"roi {i}: a cell outside its footprint"
    assert touched >= flat.shape[1] - (2 if name == "edges" else 0)


def test_roi_align_function_gradcheck_float64():
    """The autograd pairing: RoIAlignFunction's backward (the plain adjoint)
    against finite differences of the plain forward, in float64 on a tiny
    pyramid."""
    rng = np.random.RandomState(4)
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))  # P2..P5 of a 32x48 canvas
    feats = [torch.from_numpy(rng.randn(2, 3, h, w)).requires_grad_(True) for h, w in shapes]
    rois = torch.tensor([[[2.0, 3.0, 30.0, 20.0], [0.0, 0.0, 47.0, 31.0], [40.0, 25.0, 48.0, 32.0]],
                         [[5.0, 5.0, 9.0, 7.0], [-4.0, 10.0, 20.0, 40.0], [1.0, 1.0, 1.0, 1.0]]])

    def fn(*fs):
        return RoIAlignFunction.apply(cuda_roi_align._forward, rois, 3, 2,
                                      (0.25, 0.125, 0.0625, 0.03125), *fs)

    assert torch.autograd.gradcheck(fn, tuple(feats), eps=1e-6, atol=1e-5, rtol=1e-4)
    # roi_align routes through the Function when a level needs a gradient
    out = roi_align(feats, rois, 3)
    assert out.grad_fn is not None and "RoIAlignFunction" in type(out.grad_fn).__name__
    assert cuda_roi_align.roi_align.launches == 0
    assert cuda_roi_align.roi_align_adjoint.launches == 0


def test_roi_align_backward_matches_autograd_of_plain_forward():
    """f32 channels_last levels, as the model passes them: the Function's
    gradients equal torch autograd through the plain forward's gather, and
    come back in the levels' layout and dtype."""
    rng = np.random.RandomState(5)
    shapes = ((16, 24), (8, 12), (4, 6), (2, 3))
    base = [torch.from_numpy(rng.randn(2, 4, h, w).astype(np.float32)) for h, w in shapes]
    rois = torch.from_numpy(mix_rois(rng, 2, 6, canvas=(64, 96)))
    g = torch.from_numpy(rng.randn(12, 4, 7, 7).astype(np.float32))
    grads = []
    for use_fn in (True, False):
        feats = [f.clone().contiguous(memory_format=torch.channels_last).requires_grad_(True)
                 for f in base]
        out = (roi_align if use_fn else multilevel_roi_align)(feats, rois, 7)
        (out * g).sum().backward()
        grads.append([f.grad for f in feats])
    for a, b in zip(*grads):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_stem_wrapper_raises_when_a_gradient_is_needed():
    x = torch.zeros((1, 3, 16, 16))
    w = torch.zeros((64, 3, 7, 7), requires_grad=True)
    scale, shift = torch.ones(64), torch.zeros(64)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_stem.fused_stem(x, w, scale, shift, torch.float32)
    with torch.no_grad():  # inference: no gradient is needed
        assert cuda_stem.fused_stem(x, w, scale, shift, torch.float32).shape == (1, 64, 4, 4)
    assert cuda_stem.fused_stem.launches == 0
