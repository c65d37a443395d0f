"""The serving slice, port vs JAX, at the serving profile on a small canvas.

``MatchRCNN.inference`` + ``aggregator_descriptors`` + ``aggregate_sequences``
under ``serving_model_config`` (fused stem, tile-resident RoIAlign and fused
NLB; the JAX kernels run in interpret mode, the port's wrappers take their
plain versions on the CPU), f32 compute, 96x128 canvas — the setting of
tests/test_model_pallas_backend.py.  Weights are shared through the bridge.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.config import RoIHeadsConfig, RPNConfig, serving_model_config
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.ops import cuda_kernels, cuda_roi_align, cuda_stem

torch.set_num_threads(2)


def test_serving_forward_matches_jax():
    cfg = serving_model_config(
        rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
        roi_heads=RoIHeadsConfig(detections_per_img=6, roi_align_backend="pallas_resident"),
        compute_dtype="float32")
    jmodel, variables = jax_init(cfg, video=True, canvas=(96, 128))
    rng = np.random.RandomState(2)
    params = jax.tree.map(np.asarray, variables["params"])
    params["temporal_aggregator"]["nlb"]["w_z"] = {
        "kernel": (rng.randn(128, 256) * 0.05).astype(np.float32),
        "bias": (rng.randn(256) * 0.05).astype(np.float32)}
    variables = {"params": params,
                 "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}
    images = rng.rand(1, 96, 128, 3).astype(np.float32)
    sizes = np.asarray([[96, 128]], np.int32)

    def fwd(m, im, sz):
        out = m.inference(im, sz, with_masks=False)
        roi = out["roi_features"].reshape(-1, 14, 14, 256)
        out["aggr_features"] = m.aggregator_descriptors(roi).reshape(1, -1, 256)
        seq = out["aggr_features"][:, :4]  # a 4-frame track through the fused NLB
        out["video"] = m.aggregate_sequences(seq, jnp.ones((1, 4), bool))
        return out

    want = jax.tree.map(np.asarray, jmodel.apply(variables, jnp.asarray(images),
                                                 jnp.asarray(sizes), method=fwd))

    port = load_jax_variables(init_model(cfg, video=True, device="cpu"), variables)
    out = port.inference(torch.from_numpy(images).permute(0, 3, 1, 2), torch.from_numpy(sizes))
    roi = out["roi_features"]
    aggr = port.aggregator_descriptors(roi.reshape((-1,) + roi.shape[2:])).reshape(1, -1, 256)
    video = port.aggregate_sequences(aggr[:, :4], torch.ones((1, 4), dtype=torch.bool))
    for fn in (cuda_stem.fused_stem, cuda_roi_align.roi_align, cuda_kernels.nlb_aggregate):
        assert fn.launches == 0  # CPU tensors took the plain versions

    assert out["boxes"].shape == (1, 6, 4) and out["match_features"].shape == (1, 6, 256)
    v = want["valid"][0]
    np.testing.assert_array_equal(out["valid"].numpy()[0], v)
    assert v.sum() >= 2
    # f32 everywhere except the stem's bf16 output rounding (identical on both
    # sides but for rare one-ulp flips); no roi of a 96x128 canvas reaches the
    # resident kernel's 40x48-cell window clamp
    tol = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["boxes"].numpy()[0][v], want["boxes"][0][v], **tol)
    np.testing.assert_allclose(out["scores"].numpy()[0][v], want["scores"][0][v], **tol)
    np.testing.assert_allclose(out["match_features"].numpy()[0][v],
                               want["match_features"][0][v], **tol)
    np.testing.assert_allclose(aggr.numpy()[0][v], want["aggr_features"][0][v], **tol)
    np.testing.assert_allclose(video.numpy(), want["video"], **tol)
