"""SeamRetrieval, port vs JAX: build_gallery + retrieve on shared weights.

The reduced config of tests/test_serving.py (XLA backends on the JAX side —
interpret-mode kernels are too slow at the 800x1344 canvas — and the port's
plain versions on the CPU), JAX ingest on the device so both sides resize
with half-pixel bilinear interpolation.  Images are numpy rectangles on
noise at non-canvas sizes, landscape and portrait.
"""

import numpy as np
import torch

import jax

from seam_match_rcnn_tpu.config import (EvalConfig, ModelConfig, RoIHeadsConfig, RPNConfig,
                                        TransformConfig)
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.serving import SeamRetrieval as JaxSeamRetrieval

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.serving import Gallery, SeamRetrieval

torch.set_num_threads(2)


def _image(rng, h, w):
    img = rng.uniform(0.0, 0.25, (h, w, 3)).astype(np.float32)
    bh, bw = h // 2, w // 2
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    img[y:y + bh, x:x + bw] = rng.uniform(0.3, 1.0, 3)
    return img


def test_retrieval_matches_jax(tmp_path):
    cfg = ModelConfig(rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
                      roi_heads=RoIHeadsConfig(detections_per_img=6),
                      transform=TransformConfig(min_size=96, max_size=128),
                      compute_dtype="float32")
    jmodel, variables = jax_init(cfg, video=True, canvas=(64, 64))
    rng = np.random.RandomState(3)
    params = jax.tree.map(np.asarray, variables["params"])
    params["temporal_aggregator"]["nlb"]["w_z"] = {
        "kernel": (rng.randn(128, 256) * 0.05).astype(np.float32),
        "bias": (rng.randn(256) * 0.05).astype(np.float32)}
    variables = {"params": params,
                 "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}
    shops = [_image(rng, 120, 160), _image(rng, 160, 120), _image(rng, 96, 128)]
    frames = [_image(rng, 120, 160) for _ in range(3)]
    keys = ["a", "b", "c"]
    ecfg = EvalConfig(score_threshold=0.0)

    jretr = JaxSeamRetrieval(jmodel, variables, cfg=ecfg, chunk=4, ingest="device")
    jgal = jretr.build_gallery(shops, keys=keys)
    want = jretr.retrieve(frames, jgal, k=2)

    retr = SeamRetrieval(load_jax_variables(init_model(cfg, video=True, device="cpu"), variables),
                         cfg=ecfg, chunk=4)
    gal = Gallery.load(retr.build_gallery(shops, keys=keys).save(str(tmp_path / "g")))
    got = retr.retrieve(frames, gal, k=2)

    assert gal.keys == jgal.keys
    np.testing.assert_allclose(gal.aggr_feats, jgal.aggr_feats, rtol=1e-3, atol=1e-3)
    assert got.keys == want.keys
    assert got.track_length == want.track_length
    # f32 throughout; descriptors agree to ~1e-5 and the scores are sigmoids
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4)
