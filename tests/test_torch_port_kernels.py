"""Plain PyTorch versions of kernels K1-K4 vs the JAX Pallas kernels
(interpret mode) and their plain JAX references, on the CPU.

Every input is made from a seed with numpy and handed to both sides.  On a
CPU tensor each wrapper must run its plain version and leave its launch
counter at 0; the CUDA kernels themselves are checked against these plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.ops.pairwise import pairwise_match_logits as jax_logits
from seam_match_rcnn_tpu.ops.pairwise import pairwise_match_scores as jax_pairwise
from seam_match_rcnn_tpu.ops.pallas_kernels import nlb_aggregate as jax_nlb_aggregate
from seam_match_rcnn_tpu.ops.pallas_kernels import pairwise_scores as jax_pairwise_kernel
from seam_match_rcnn_tpu.ops.pallas_roi_align import footprint_clamp_mask
from seam_match_rcnn_tpu.ops.pallas_roi_align_resident import pallas_roi_align_resident
from seam_match_rcnn_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from seam_match_rcnn_tpu.ops.roi_align import multilevel_roi_align as jax_roi_align

from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_logits

torch.set_num_threads(2)


# ---- K1: fused stem ------------------------------------------------------

def _xla_stem(x, w, scale, shift):
    y = jax.lax.conv_general_dilated(
        x, w, (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = jnp.maximum(y * scale + shift, 0.0)
    return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 [(0, 0), (1, 1), (1, 1), (0, 0)])


@pytest.mark.parametrize("b,h,w,seed", [(1, 64, 96, 0), (2, 128, 64, 1), (1, 160, 128, 2),
                                        # pooled 17x25: no 8x16 tile of K1 divides it
                                        (1, 68, 100, 3)])
def test_k1_stem_plain_matches_pallas_and_xla(b, h, w, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, 3).astype(np.float32)
    cw = (rng.randn(7, 7, 3, 64) * 0.2).astype(np.float32)
    scale = (0.5 + rng.rand(64)).astype(np.float32)
    shift = rng.randn(64).astype(np.float32)
    got = cuda_stem.fused_stem(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(cw).permute(3, 2, 0, 1),
                               torch.from_numpy(scale), torch.from_numpy(shift),
                               torch.float32).permute(0, 2, 3, 1).numpy()
    assert cuda_stem.fused_stem.launches == 0
    pallas = np.asarray(jax_fused_stem(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(scale),
                                       jnp.asarray(shift), interpret=True))
    assert got.shape == pallas.shape == (b, h // 4, w // 4, 64)
    s = np.abs(pallas).max()
    # same bf16 operands and f32 sums; only the summation order differs,
    # which can move a value across a bf16 rounding boundary of the output:
    # such rare elements differ by one bf16 ulp, all others by 1e-4 x max
    err = np.abs(got - pallas)
    flips = err > 1e-4 * s
    bf16_ulp = 2.0 ** (np.floor(np.log2(np.abs(pallas[flips]))) - 7)
    assert np.all(err[flips] <= bf16_ulp)
    assert flips.mean() < 1e-3
    # against the f32 XLA stem: the bf16 bound of tests/test_pallas_stem.py
    want = np.asarray(_xla_stem(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(scale),
                                jnp.asarray(shift)))
    np.testing.assert_allclose(got, want, atol=2e-2 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k1_stem_rounds_f32_input_on_load(out_dtype):
    """The kernel reads the model's f32 images and rounds them to bf16 as it
    loads them: f32 and bf16 input give the same output, and an f32 output
    holds the bf16-rounded value."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 3, 68, 100).astype(np.float32))
    cw = torch.from_numpy((rng.randn(64, 3, 7, 7) * 0.2).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(64)).astype(np.float32))
    shift = torch.from_numpy(rng.randn(64).astype(np.float32))
    got = cuda_stem.fused_stem(x, cw, scale, shift, out_dtype)
    assert cuda_stem.fused_stem.launches == 0
    assert got.dtype == out_dtype and got.shape == (2, 64, 17, 25)
    assert torch.equal(got, cuda_stem.fused_stem(x.to(torch.bfloat16), cw, scale, shift,
                                                 out_dtype))
    bf16 = cuda_stem.fused_stem(x, cw, scale, shift, torch.bfloat16)
    assert torch.equal(got.to(torch.float32), bf16.to(torch.float32))


# ---- K2: RoIAlign --------------------------------------------------------

LEVELS = ((96, 120), (48, 60), (24, 30), (12, 15))  # P2..P5 of a 384x480 canvas


def _pyramid(rng, b, c, dtype=np.float32):
    return [rng.randn(b, h, w, c).astype(dtype) for h, w in LEVELS]


def _rois(rng, b, n):
    """A mix hitting every level: tiny (< 1 cell), edge-crossing, elongated
    and large rois in a 384x480 image."""
    out = []
    for _ in range(b):
        cx, cy = rng.uniform(-8, 488, n), rng.uniform(-8, 392, n)
        w = np.exp(rng.uniform(np.log(0.5), np.log(700), n))
        h = w * np.exp(rng.uniform(np.log(0.2), np.log(5), n))
        out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
    return np.asarray(out, np.float32)


def _border_rois(rng, b):
    """The border class of the K5 card tests on this 384x480 canvas: on and
    beyond the canvas edges, degenerate, tiny, the whole canvas."""
    base = np.asarray([[0, 0, 40, 40], [438, 340, 480, 384], [-20, -20, 30, 30],
                       [450, 0, 500, 384], [0, 370, 480, 400], [100, 100, 100, 100],
                       [0, 0, 2, 2], [0, 0, 480, 384]], np.float32)
    return np.stack([base[rng.permutation(len(base))] for _ in range(b)])


def _port_roi_align(feats, rois, o):
    return cuda_roi_align.roi_align(
        [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
        torch.from_numpy(rois), o)


def _jax_exact_roi_align(feats, rois, o):
    """The plain JAX RoIAlign run op by op.  Jitted, XLA contracts
    roi * scale + offset into an FMA, which moves a sample coordinate one f32
    ulp away from the separately rounded product and sum that the port (and
    its kernel, built with -fmad=false) computes; op by op, both sides round
    every geometry step alike."""
    with jax.disable_jit():
        return np.asarray(jax_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), o)
                          .astype(jnp.float32))


@pytest.mark.parametrize("o,kind", [pytest.param(7, "mix", id="7"),
                                    pytest.param(14, "mix", id="14"),
                                    pytest.param(7, "borders", id="7-borders"),
                                    pytest.param(14, "borders", id="14-borders")])
def test_k2_roi_align_plain_matches_exact_and_resident(o, kind):
    rng = np.random.RandomState(10 + o)
    b, c = 2, 8
    feats = _pyramid(rng, b, c)
    rois = _rois(rng, b, 48) if kind == "mix" else _border_rois(rng, b)
    n = rois.shape[1]
    got = _port_roi_align(feats, rois, o).permute(0, 2, 3, 1).numpy().reshape(b, n, o, o, c)
    assert cuda_roi_align.roi_align.launches == 0
    lv = np.asarray([[((np.sqrt(max((r[2] - r[0]) * (r[3] - r[1]), 0)) / 224) + 1e-12)
                      for r in img] for img in rois])
    lv = np.clip(np.floor(4 + np.log2(lv) + 1e-6), 2, 5)
    assert set(np.unique(lv)) == ({2, 3, 4, 5} if kind == "mix" else {2, 3, 4})
    for i in range(b):
        # same geometry arithmetic; only the order of the f32 sums differs
        want = _jax_exact_roi_align([f[i] for f in feats], rois[i], o)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
    # the TPU kernel (40x48-cell window) agrees wherever it does not clamp
    res, order = pallas_roi_align_resident(tuple(jnp.asarray(f) for f in feats),
                                           jnp.asarray(rois), o, interpret=True)
    res_nat = np.zeros_like(np.asarray(res))
    res_nat[np.asarray(order)] = np.asarray(res)
    clamp = np.asarray(footprint_clamp_mask(jnp.asarray(rois.reshape(-1, 4)), LEVELS,
                                            output_size=o)).reshape(-1)
    ok = ~clamp
    assert ok.sum() > (0.8 if kind == "mix" else 0.7) * ok.size
    np.testing.assert_allclose(got.reshape(b * n, o, o, c)[ok], res_nat[ok],
                               rtol=1e-4, atol=1e-4)


def test_k2_roi_align_bf16_at_bf16_bound():
    rng = np.random.RandomState(3)
    b, n, c = 1, 40, 8
    feats, rois = _pyramid(rng, b, c), _rois(rng, b, n)
    got = cuda_roi_align.roi_align(
        [torch.from_numpy(f).permute(0, 3, 1, 2).to(torch.bfloat16) for f in feats],
        torch.from_numpy(rois), 7)
    assert got.dtype == torch.bfloat16
    want = _jax_exact_roi_align([jnp.asarray(f[0]).astype(jnp.bfloat16) for f in feats],
                                rois[0], 7)
    got = got.to(torch.float32).permute(0, 2, 3, 1).numpy()
    # both sum in f32 and round to bf16 once: one bf16 ulp apart at most
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# ---- K3: NLB aggregation -------------------------------------------------

def _nlb_params(rng, c=256):
    ci = c // 2
    d = lambda i, o: (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)
    bias = lambda o: (rng.randn(o) * 0.1).astype(np.float32)
    return {
        "nlb": {"theta": {"kernel": d(c, ci), "bias": bias(ci)},
                "phi": {"kernel": d(c, ci), "bias": bias(ci)},
                "g": {"kernel": d(c, ci), "bias": bias(ci)},
                "w_z": {"kernel": d(ci, c), "bias": bias(c)},  # non-zero W_z
                "concat_w": d(2 * ci, 1)},
        "attention_scorer": {"kernel": d(c, 1), "bias": bias(1)},
    }


def _port_nlb_weights(p):
    t = lambda a: torch.from_numpy(np.asarray(a))
    n = p["nlb"]
    return {"theta_w": t(n["theta"]["kernel"]), "theta_b": t(n["theta"]["bias"]),
            "phi_w": t(n["phi"]["kernel"]), "phi_b": t(n["phi"]["bias"]),
            "g_w": t(n["g"]["kernel"]), "g_b": t(n["g"]["bias"]),
            "wcat": t(n["concat_w"][:, 0]), "wz_w": t(n["w_z"]["kernel"]),
            "wz_b": t(n["w_z"]["bias"]),
            "att_w": t(p["attention_scorer"]["kernel"][:, 0]),
            "att_b": t(p["attention_scorer"]["bias"])}


def test_k3_nlb_plain_matches_pallas_and_xla():
    from seam_match_rcnn_tpu.models.match_head import TemporalAggregator

    rng = np.random.RandomState(5)
    p = _nlb_params(rng)
    lengths = [1, 2, 10]
    seqs = rng.randn(3, 12, 256).astype(np.float32)
    mask = np.zeros((3, 12), bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    seqs *= mask[..., None]
    got = cuda_kernels.nlb_aggregate(torch.from_numpy(seqs), torch.from_numpy(mask),
                                     _port_nlb_weights(p)).numpy()
    assert cuda_kernels.nlb_aggregate.launches == 0
    jp = jax.tree.map(jnp.asarray, p)
    pallas = np.asarray(jax_nlb_aggregate(jnp.asarray(seqs), jnp.asarray(mask), jp,
                                          interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    # the XLA TemporalAggregator path with the same weights
    mod = TemporalAggregator(nlb_backend="xla")
    roi = jnp.zeros((1, 14, 14, 256), jnp.float32)
    variables = mod.init(jax.random.PRNGKey(0), roi, jnp.zeros((1, 2), jnp.int32),
                         jnp.ones((1, 2), bool), jnp.asarray([0]))
    params = dict(variables["params"])
    params["nlb"], params["attention_scorer"] = jp["nlb"], jp["attention_scorer"]
    xla = np.asarray(mod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(seqs), jnp.asarray(mask),
                               method=TemporalAggregator.aggregate))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


# ---- K4: pairwise scores -------------------------------------------------

@pytest.mark.parametrize("q,g,kind", [
    pytest.param(1, 7, "near", id="1-7"), pytest.param(37, 300, "near", id="37-300"),
    pytest.param(260, 19, "near", id="260-19"), pytest.param(1, 16, "near", id="1-16"),
    pytest.param(16, 1000, "near", id="16-1000"),
    pytest.param(1, 16, "exact", id="1-16-exact"),
    pytest.param(37, 300, "exact", id="37-300-exact"),
    pytest.param(37, 300, "x10", id="37-300-x10")])
def test_k4_pairwise_plain_matches_pallas_and_xla(q, g, kind):
    rng = np.random.RandomState(q + g)
    x = rng.randn(q, 256).astype(np.float32)
    y = rng.randn(g, 256).astype(np.float32)
    m = min(q, g)
    if kind == "exact":  # x_i == y_j: d = c0 up to the rounding of a + g - 2 cross
        y[:m] = x[:m]
    else:
        y[:m] = x[:m] + 1e-3 * rng.randn(m, 256)  # near-duplicates
    scale = 10.0 if kind == "x10" else 1.0
    x, y = x * scale, y * scale
    w = (rng.randn(2, 256) * 0.05).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    got = cuda_kernels.pairwise_scores(*map(torch.from_numpy, (x, y, w, b))).numpy()
    assert cuda_kernels.pairwise_scores.launches == 0
    assert got.shape == (q, g)
    # a_i, g_j and the cross term are f32 sums of 256 terms of size |x|^2 |v|,
    # in another order on each side: their rounding grows with |x|^2, so the
    # tolerance is 1e-5 at unit scale and 100x that at x10 scale
    tol = 1e-5 * scale ** 2
    pallas = np.asarray(jax_pairwise_kernel(*map(jnp.asarray, (x, y, w, b)), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    xla = np.asarray(jax_pairwise(*map(jnp.asarray, (x, y, w, b))))
    np.testing.assert_allclose(got, xla, rtol=tol, atol=tol)
    # the two-logit form behind PairScorer.score_pairs (logits are O(10) at
    # unit scale: f32 sums of 256 squared differences in another order)
    logits = pairwise_match_logits(*map(torch.from_numpy, (x, y, w, b))).numpy()
    np.testing.assert_allclose(logits, np.asarray(jax_logits(*map(jnp.asarray, (x, y, w, b)))),
                               rtol=1e-5, atol=1e-4 * scale ** 2)
