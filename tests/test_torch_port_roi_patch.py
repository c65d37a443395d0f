"""The patch-window RoIAlign (kernels K6 and K7), port vs JAX on the CPU.

The port's plain versions (``ops/roi_align_patch.py``, which the wrappers
take for CPU tensors) against the JAX package's Pallas kernel
(``pallas_roi_align_batched``) in interpret mode, its int8 quantization, its
geometry, its exact fixup, its trainable wrapper and the model's backend
dispatch, on 2-image pyramids of a 256x384 canvas.  The rois
mix moderate boxes, boxes on and beyond the border, and elongated boxes that
overflow the 40x48-cell window (``footprint_clamp_mask``).  Each JAX kernel
result is computed once per module, and the f32 7x7 and int8 7x7 ones are
called as the JAX model calls them, so that its dispatch reuses their
compiles.  An interpret-mode compile costs 5-25 s and grows with the rois
per grid program, which fall as the channels grow: the pyramids have 512
channels (2 rois a program in f32, 4 in bf16) and 1024 for int8 (4).

The JAX package's exact RoIAlign and its adjoint, jitted, contract roi *
scale + offset into a fused multiply-add, which moves a sample coordinate
one f32 ulp from the separately rounded product and sum of the port (and of
its kernels); run op by op, both sides round every step alike (as in
tests/test_torch_port_kernels.py).  Where the JAX side cannot run op by op
(the model's dispatch), rows of the exact path are held at 1e-4, not 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.config import ModelConfig, RoIHeadsConfig
from seam_match_rcnn_tpu.models.matchrcnn import MatchRCNN as JaxMatchRCNN
from seam_match_rcnn_tpu.ops import pallas_roi_align as jpatch

from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN
from seam_match_rcnn_tpu_torch.ops import cuda_roi_align
from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
from seam_match_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align

torch.set_num_threads(2)

B, C, C_INT8 = 2, 512, 1024
LEVELS = ((64, 96), (32, 48), (16, 24), (8, 12))  # P2..P5 of a 256x384 canvas
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rois(rng, n_moderate=6, n_extreme=8):
    h, w = 256, 384
    out = []
    for _ in range(n_moderate):
        side, a = rng.uniform(8, 200), rng.uniform(0.6, 1.6)
        bw, bh = side * np.sqrt(a), side / np.sqrt(a)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, max(h - bh, 1))
        out.append([x1, y1, x1 + bw, min(y1 + bh, h)])
    for _ in range(n_extreme):  # aspect 1..4 at the top of a level band
        side, a = rng.uniform(40, 220), rng.uniform(1.0, 4.0)
        bw, bh = (side * np.sqrt(a), side / np.sqrt(a)) if rng.rand() < 0.5 else (
            side / np.sqrt(a), side * np.sqrt(a))
        x1, y1 = rng.uniform(0, max(w - bw, 1)), rng.uniform(0, max(h - bh, 1))
        out.append([x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1)])
    out += [[0, 0, 30, 40], [350, 220, 384, 256], [0, 0, 384, 256], [5, 5, 6, 6],
            [-10, -5, 40, 30], [300, 200, 420, 280]]  # corners, whole, tiny, beyond
    out += [[x, 4, x + 62, 191] for x in (8.0, 170.0)]   # tall: 46-cell footprint at P2
    out += [[4, y, 191, y + 62] for y in (10.0, 150.0)]  # wide
    return np.asarray(out, np.float32)


def _data(c):
    rng = np.random.RandomState(0)
    rois = np.stack([_rois(rng) for _ in range(B)])
    return [rng.randn(B, h, w, c).astype(np.float32) for h, w in LEVELS], rois


@pytest.fixture(scope="module")
def data():
    return _data(C)


@pytest.fixture(scope="module")
def data_int8():
    return _data(C_INT8)


def _port_levels(feats, dtype=torch.float32):
    return [torch.from_numpy(f).permute(0, 3, 1, 2).to(dtype)
            .contiguous(memory_format=torch.channels_last) for f in feats]


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.fixture(scope="module")
def jax_k6(data):
    """JAX K6 outputs by (dtype, output size), computed on first use: f32 7x7
    as the model's trainable wrapper calls the kernel (its 2048-roi chunk),
    the others with one chunk of this module's rois."""
    feats, rois = data
    cache = {}

    def get(dtype, o):
        if (dtype, o) not in cache:
            jf = [jnp.asarray(f, JAX_DT[dtype]) for f in feats]
            kw = {} if (dtype, o) == (torch.float32, 7) else {"roi_chunk": rois.size // 4}
            out = jpatch.pallas_roi_align_batched(jf, jnp.asarray(rois), o, 2,
                                                  out_dtype=jnp.dtype(JAX_DT[dtype]), **kw)
            cache[dtype, o] = np.asarray(out.astype(jnp.float32)).reshape(-1, o, o, C)
        return cache[dtype, o]
    return get


@pytest.fixture(scope="module")
def jax_k7(data_int8):
    feats, rois = data_int8
    qs, scales = jpatch.quantize_features_int8([jnp.asarray(f) for f in feats])
    # called as the JAX model calls it
    out = jpatch.pallas_roi_align_batched(qs, jnp.asarray(rois), 7, sampling_ratio=2,
                                          scales=scales, out_dtype=jnp.dtype(jnp.float32))
    return ([np.asarray(q) for q in qs], np.asarray(scales),
            np.asarray(out).reshape(-1, 7, 7, C_INT8))


def _clamped(rois, o):
    return patch.footprint_clamp_mask(torch.from_numpy(rois), LEVELS, output_size=o).numpy()


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("o", [7, 14])
def test_footprint_clamp_mask_matches_jax(data, o):
    _, rois = data
    want = np.asarray(jpatch.footprint_clamp_mask(jnp.asarray(rois), LEVELS, output_size=o))
    got = _clamped(rois, o)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()  # the fixture mixes both kinds


@pytest.mark.parametrize("dtype,o", [(torch.float32, 7), (torch.float32, 14),
                                     (torch.bfloat16, 7), (torch.bfloat16, 14)])
def test_k6_plain_matches_jax(data, jax_k6, dtype, o):
    feats, rois = data
    want = jax_k6(dtype, o)
    got = _nhwc(cuda_roi_align.roi_align_patch(_port_levels(feats, dtype),
                                               torch.from_numpy(rois), o))
    assert cuda_roi_align.roi_align_patch.launches == 0  # CPU tensors: the plain version
    err = np.abs(got - want)
    if dtype == torch.float32:
        # the same operator entries; only the order of the f32 sums differs
        assert err.max() <= 1e-5, err.max()
    else:
        # bf16 entries and features, exact products, f32 sums rounded to bf16
        # once: a sum order may cross a rounding boundary (one ulp), rarely
        assert np.all(err <= _bf16_ulp(want)) and (err > 0).mean() < 1e-3
    # the window was ported: on the clamped rois, where both sides agree (as
    # everywhere), both leave the exact function
    flagged = _clamped(rois, o).reshape(-1)
    exact = _nhwc(multilevel_roi_align(_port_levels(feats, dtype), torch.from_numpy(rois), o))
    off = np.abs(got - exact).max(axis=(1, 2, 3))
    assert flagged.sum() >= 4 and np.all(off[flagged] > 1e-2), off[flagged]


def test_k7_plain_matches_jax(data_int8, jax_k7):
    feats, rois = data_int8
    jq, jscales, want = jax_k7
    q, scales = patch.quantize_features_int8(_port_levels(feats))
    assert scales.dtype == torch.float32 and all(t.dtype == torch.int8 for t in q)
    np.testing.assert_array_equal(scales.numpy(), jscales)  # bit for bit
    for a, b in zip(q, jq):
        np.testing.assert_array_equal(a.permute(0, 2, 3, 1).numpy(), b)
    got = _nhwc(cuda_roi_align.roi_align_patch_int8(q, scales, torch.from_numpy(rois), 7,
                                                    torch.float32))
    assert cuda_roi_align.roi_align_patch_int8.launches == 0
    # integer sums are exact in any order and the dequantization rounds as
    # XLA's does: tolerance 0
    np.testing.assert_array_equal(got, want)


def _border_rois(rng):
    """[B, 24, 4] rois (the fixture's shape, so that the JAX kernels' compiles
    are shared): at each level (square rois of side 40, 150, 300 and 520 map
    to P2..P5), one ending on the canvas's last row and column, one reaching
    beyond them, one on the last column at the top, and one whose window
    starts at column -1 by the 8-aligned rule (first cell 1..6); the
    fixture's four window-overflowing slivers; the last cell of P2, a
    one-pixel roi on it, the whole canvas and a roi around it."""
    h, w = 256, 384
    out = []
    for _ in range(B):
        rows = []
        for lv, side in enumerate((40.0, 150.0, 300.0, 520.0)):
            s = side * rng.uniform(0.97, 1.03)
            u, y = rng.uniform(1.0, 6.5) * 4 * 2 ** lv, rng.uniform(-20, h - s / 2)
            rows += [[w - s, h - s, w, h], [w - s / 2, h - s / 2, w + s / 2, h + s / 2],
                     [w - s, 0, w, s], [u, y, u + s, y + s]]
        rows += [[x, 4, x + 62, 191] for x in (8.0, 170.0)]
        rows += [[4, y, 191, y + 62] for y in (10.0, 150.0)]
        rows += [[380, 252, 384, 256], [383, 255, 384, 256], [0, 0, w, h], [-10, -10, w + 10,
                                                                              h + 10]]
        out.append(rows)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k6_k7_plain_on_border_rois_matches_jax(data, data_int8, kind):
    """The window geometry that the kernels now compute themselves (level,
    origin with the 8-aligned column rule, bounds) on rois at each level's
    last row and column and at window column -1, K6 (f32) and K7 against
    the JAX kernel."""
    rois = _border_rois(np.random.RandomState(2))
    assert rois.shape == data[1].shape
    flat = torch.from_numpy(rois.reshape(-1, 4))
    lvl, _, x0, _ = patch.patch_geometry(flat, LEVELS, (0.25, 0.125, 0.0625, 0.03125), 7)
    assert set(lvl[(x0 == -1) & (flat[:, 0] > 0)].tolist()) == {0, 1, 2, 3}
    for level, (h, w) in enumerate(LEVELS):  # some roi reaches the last row and column
        sc = 0.25 / 2 ** level
        at = lvl == level
        assert ((flat[at, 3] * sc >= h) & (flat[at, 2] * sc >= w)).any()
    assert _clamped(rois, 7).sum() >= 4
    if kind == "f32":
        feats = data[0]
        want = np.asarray(jpatch.pallas_roi_align_batched(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois), 7, 2,
            out_dtype=jnp.dtype(jnp.float32))).reshape(-1, 7, 7, C)
        got = _nhwc(cuda_roi_align.roi_align_patch(_port_levels(feats), torch.from_numpy(rois),
                                                   7))
        assert cuda_roi_align.roi_align_patch.launches == 0
        # the same operator entries; only the order of the f32 sums differs
        assert np.abs(got - want).max() <= 1e-5
    else:
        feats = data_int8[0]
        qs, scales = jpatch.quantize_features_int8([jnp.asarray(f) for f in feats])
        want = np.asarray(jpatch.pallas_roi_align_batched(
            qs, jnp.asarray(rois), 7, sampling_ratio=2, scales=scales,
            out_dtype=jnp.dtype(jnp.float32))).reshape(-1, 7, 7, C_INT8)
        q, s = patch.quantize_features_int8(_port_levels(feats))
        got = _nhwc(cuda_roi_align.roi_align_patch_int8(q, s, torch.from_numpy(rois), 7,
                                                        torch.float32))
        assert cuda_roi_align.roi_align_patch_int8.launches == 0
        # integer sums and the same dequantization: tolerance 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("budget", [64, 3])
def test_exact_fixup_matches_jax(data, jax_k6, budget):
    """A budget above the clamped count makes every clamped roi exact; a
    smaller one takes the first ``budget`` of each image, as lax.top_k."""
    feats, rois = data
    o = 7
    flagged = _clamped(rois, o)
    assert (flagged.sum(axis=1) > 3).all()  # the small budget leaves some clamped
    jf = tuple(jnp.asarray(f) for f in feats)
    base = jax_k6(torch.float32, o)
    want = np.asarray(jpatch.apply_exact_fixup(
        jf, jnp.asarray(rois), jnp.asarray(base.reshape(B, -1, o, o, C)), o, 2, budget))
    want = want.reshape(-1, o, o, C)
    levels = _port_levels(feats)
    start = patch.roi_align_patch(levels, torch.from_numpy(rois), o)
    got = _nhwc(patch.apply_exact_fixup(levels, torch.from_numpy(rois), start, o, 2, budget))
    exact = _nhwc(multilevel_roi_align(levels, torch.from_numpy(rois), o))
    # the same rows are replaced on both sides: the first ``budget`` clamped
    # rois of each image
    replaced = np.any(want != base, axis=(1, 2, 3))
    first = (flagged & (np.cumsum(flagged, axis=1) <= budget)).reshape(-1)
    np.testing.assert_array_equal(replaced, first)
    # by the port's exact path (K2's plain version, held against the JAX
    # exact path at 1e-5 op by op in tests/test_torch_port_kernels.py; the
    # jitted JAX fixup moves coordinates by an ulp, see the docstring)
    np.testing.assert_array_equal(got[first], exact[first])
    np.testing.assert_allclose(got[first], want[first], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[~first], _nhwc(start)[~first])
    np.testing.assert_allclose(got[~first], want[~first], rtol=0, atol=1e-5)


def test_trainable_k6_gradients_match_jax(data):
    """The "pallas" backend's gradient: K6 forward, the exact adjoint (K5's
    plain version) backward, against ``pallas_roi_align_trainable(...,
    adjoint="xla")``; no gradient for the rois."""
    feats, rois = data
    rng = np.random.RandomState(1)
    g = rng.randn(B * rois.shape[1], 7, 7, C).astype(np.float32)
    jf = tuple(jnp.asarray(f) for f in feats)
    _, vjp = jax.vjp(lambda fs: jpatch.pallas_roi_align_trainable(
        fs, jnp.asarray(rois), 7, 2, jnp.dtype(jnp.float32), "xla"), jf)
    with jax.disable_jit():  # the adjoint op by op (module docstring)
        (want,) = vjp(jnp.asarray(g.reshape(B, -1, 7, 7, C)))
    levels = [t.requires_grad_(True) for t in _port_levels(feats)]
    out = cuda_roi_align.roi_align_patch(levels, torch.from_numpy(rois), 7)
    assert "RoIAlignFunction" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    for lv, (t, w) in enumerate(zip(levels, want)):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5, err_msg=f"level {lv}")


@pytest.mark.parametrize("backend", ["pallas", "pallas_int8"])
def test_backend_dispatch_matches_jax(data, data_int8, backend):
    """``MatchRCNN._roi_align`` of both packages under the window backends at
    7x7, with the exact fixup on (budget 3) and, for int8, the pyramid of
    ``_quantize_pyramid``, which the forward makes once and hands to every
    RoIAlign call (and which a call under "pallas_int8" cannot do without)."""
    feats, rois = data if backend == "pallas" else data_int8
    c = feats[0].shape[-1]
    cfg = ModelConfig(compute_dtype="float32", roi_heads=RoIHeadsConfig(
        roi_align_backend=backend, roi_align_fixup_budget=3))
    jm = JaxMatchRCNN(cfg, video=True)
    jf = [jnp.asarray(f) for f in feats]
    with torch.device("meta"):
        port = MatchRCNN(cfg, video=True)
    levels = port.roi_levels(_port_levels(feats))
    assert all(t.is_contiguous(memory_format=torch.channels_last) for t in levels)
    pq = port._quantize_pyramid(levels)
    jpq = jm.apply({}, jf, method=JaxMatchRCNN._quantize_pyramid)
    assert (pq is None) == (backend == "pallas") == (jpq is None)
    if pq is not None:
        for a, b in zip(pq[0] + [pq[1]], jpq[0] + [jpq[1]]):
            np.testing.assert_array_equal(
                (a.permute(0, 2, 3, 1) if a.dim() == 4 else a).numpy(), np.asarray(b))
    want = np.asarray(jm.apply({}, jf, jnp.asarray(rois), 7, 500, jpq,
                               method=JaxMatchRCNN._roi_align)).reshape(-1, 7, 7, c)
    got = _nhwc(port._roi_align(levels, torch.from_numpy(rois), 7, pq))
    flagged = _clamped(rois, 7)
    fixed = (flagged & (np.cumsum(flagged, axis=1) <= 3)).reshape(-1)
    assert fixed.sum() == 2 * 3
    # window rows: equal integers and dequantization (int8), f32 sums in
    # another order (pallas); fixed rows: the jitted exact path (docstring)
    np.testing.assert_allclose(got[~fixed], want[~fixed], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[fixed], want[fixed], rtol=0, atol=1e-4)
    if backend == "pallas_int8":  # scales of another batch would differ: no own quantization
        with pytest.raises(ValueError, match="prequant"):
            port._roi_align(levels, torch.from_numpy(rois), 7)
