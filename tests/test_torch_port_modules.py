"""The port's modules against the JAX package, one stage at a time, on the CPU.

Both sides share weights through the bridge (``ckpt/from_jax``) and inputs
made from a seed with numpy.  Each stage is fed the JAX stage's own inputs,
so discrete decisions upstream (top-k, NMS) cannot leak into the numeric
comparison of a later stage.  Config: f32 compute, exact (XLA) backends,
reduced RPN/detection counts, a 96x128 image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.ckpt.torch_convert import convert_state_dict
from seam_match_rcnn_tpu.config import ModelConfig, RoIHeadsConfig, RPNConfig, TransformConfig
from seam_match_rcnn_tpu.models.detection import postprocess_detections as jax_postprocess
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.models.resnet import BackboneWithFPN as JaxBackbone
from seam_match_rcnn_tpu.models.transform import _device_ingest
from seam_match_rcnn_tpu.ops.nms import nms_kept_mask as jax_nms_kept, nms_padded as jax_nms_padded

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.detection import postprocess_detections
from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN, init_model
from seam_match_rcnn_tpu_torch.models.resnet import BackboneWithFPN
from seam_match_rcnn_tpu_torch.models.rpn import flatten_rpn_outputs, select_proposals
from seam_match_rcnn_tpu_torch.models.transform import device_ingest
from seam_match_rcnn_tpu_torch.ops.nms import nms_kept_mask, nms_padded

torch.set_num_threads(2)

CFG = ModelConfig(rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
                  roi_heads=RoIHeadsConfig(detections_per_img=6), compute_dtype="float32")
H, W = 96, 128


def nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def models():
    jmodel, variables = jax_init(CFG, video=True, canvas=(H, W))
    # randomize the zero-initialized NLB output projection
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.asarray, variables["params"])
    params["temporal_aggregator"]["nlb"]["w_z"] = {
        "kernel": (rng.randn(128, 256) * 0.05).astype(np.float32),
        "bias": (rng.randn(256) * 0.05).astype(np.float32)}
    variables = {"params": params,
                 "batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}
    port = load_jax_variables(init_model(CFG, video=True, device="cpu"), variables)
    images = rng.rand(1, H, W, 3).astype(np.float32)
    sizes = np.asarray([[H, W - 8]], np.int32)
    return jmodel, variables, port, images, sizes


def test_bridge_round_trips_every_leaf(models):
    _, variables, port, _, _ = models
    back = convert_state_dict(port.state_dict(), video=True)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        # FrozenBN: (1 - 1e-5) + 1e-5 == 1.0 in f32, so scale/shift come back exact
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_bridge_raises_on_missing_and_leftover_leaves(models):
    _, variables, _, _, _ = models
    port = MatchRCNN(CFG, video=True)
    missing = jax.tree.map(lambda x: x, variables)
    del missing["params"]["rpn_head"]["conv"]["bias"]
    with pytest.raises(KeyError):
        load_jax_variables(port, missing)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["rpn_head"]["unused"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError):
        load_jax_variables(port, extra)


@pytest.mark.parametrize("shape,dtype", [((2, 90, 120, 3), np.uint8), ((1, 200, 150, 3), np.float32)])
def test_transform_matches_device_ingest(shape, dtype):
    cfg = TransformConfig(min_size=96, max_size=160)
    rng = np.random.RandomState(1)
    frames = (rng.rand(*shape) * 255).astype(dtype) if dtype == np.uint8 else rng.rand(*shape).astype(dtype)
    want = np.asarray(_device_ingest(jnp.asarray(frames), cfg))
    got = nhwc(device_ingest(torch.from_numpy(frames), cfg))
    assert got.shape == want.shape
    # both are half-pixel bilinear without antialiasing; f32 weights
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nms_matches_jax_with_exact_ties():
    rng = np.random.RandomState(2)
    m, n = 3, 300
    xy = rng.uniform(0, 100, (m, n, 2))
    wh = rng.uniform(5, 40, (m, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.round(rng.rand(m, n), 2).astype(np.float32)  # many exact ties
    valid = rng.rand(m, n) > 0.1
    got_kept = nms_kept_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                             valid=torch.from_numpy(valid)).numpy()
    got_idx, got_mask = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 50,
                                   valid=torch.from_numpy(valid))
    for i in range(m):
        want_kept = np.asarray(jax_nms_kept(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5,
                                            valid=jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got_kept[i], want_kept)
        idx, mask = jax_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5, 50,
                                   valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_mask[i].numpy(), np.asarray(mask))


@pytest.mark.parametrize("stem", ["xla", "pallas"])
def test_backbone_fpn_matches_jax(models, stem):
    _, variables, port, images, _ = models
    x = (images - np.asarray(CFG.transform.image_mean)) / np.asarray(CFG.transform.image_std)
    x = x.astype(np.float32)
    want = JaxBackbone(dtype=jnp.float32, stem_backend=stem).apply(
        {"params": variables["params"]["backbone"]}, jnp.asarray(x))
    bb = BackboneWithFPN(torch.float32, stem)
    bb.load_state_dict(port.backbone.state_dict())
    with torch.no_grad():
        got = bb(nchw(x))
    for lv, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        # f32 convolutions summed in another order through 50 layers; the
        # pallas stem also rounds its output to bf16, where a summation-order
        # difference can flip a rare element by one bf16 ulp
        tol = 1e-4 if stem == "xla" else 2e-3
        np.testing.assert_allclose(nhwc(g), w, atol=tol * np.abs(w).max(), err_msg=f"P{lv + 2}")


def _jax_stages(jmodel, variables, images, sizes):
    def fwd(m, im, sz):
        feats = m.features(im)
        (obj, regs), (props, scores, pvalid) = m.proposals(feats, sz, training=False)
        logits, deltas = m.box_branch(feats, props)
        det = jax_postprocess(logits, deltas, props, pvalid, sz, m.cfg.roi_heads,
                              fallback_score=0.1)
        roi14 = m.mask_roi(feats, det.boxes).astype(jnp.float32)
        b, d = det.boxes.shape[:2]
        flat = roi14.reshape(b * d, 14, 14, -1)
        return dict(feats=feats, obj=obj, regs=regs, props=props, pscores=scores,
                    pvalid=pvalid, logits=logits, deltas=deltas, det=det, roi14=flat,
                    match=m.match_descriptors(flat), aggr=m.aggregator_descriptors(flat))
    return jax.tree.map(np.array, jmodel.apply(variables, jnp.asarray(images),  # writable copies
                                               jnp.asarray(sizes), method=fwd))


@pytest.fixture(scope="module")
def stages(models):
    jmodel, variables, _, images, sizes = models
    return _jax_stages(jmodel, variables, images, sizes)


def test_rpn_head_and_proposals_match_jax(models, stages):
    _, _, port, _, sizes = models
    feats = [nchw(f) for f in stages["feats"]]
    with torch.no_grad():
        obj, regs = port.rpn["head"](feats)
    # f32 3x3 and 1x1 convs summed in another order
    for o, r, jo, jr in zip(obj, regs, stages["obj"], stages["regs"]):
        np.testing.assert_allclose(nhwc(o), jo, rtol=1e-4, atol=1e-4 * np.abs(jo).max())
        np.testing.assert_allclose(nhwc(r), jr, rtol=1e-4, atol=1e-4 * np.abs(jr).max())
    # the selector fed JAX's own head outputs
    logits, deltas = flatten_rpn_outputs([nchw(o) for o in stages["obj"]],
                                         [nchw(r) for r in stages["regs"]])
    props, scores, valid = select_proposals(logits, deltas, port._grid_anchors(feats),
                                            torch.from_numpy(sizes), CFG.rpn)
    np.testing.assert_array_equal(valid.numpy(), stages["pvalid"])
    v = stages["pvalid"]
    assert v.sum() > 20
    # identical f32 arithmetic on identical inputs
    np.testing.assert_allclose(props.numpy()[v], stages["props"][v], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(scores.numpy()[v], stages["pscores"][v])


def test_box_branch_and_postprocess_match_jax(models, stages):
    _, _, port, _, sizes = models
    feats = [nchw(f) for f in stages["feats"]]
    props = torch.from_numpy(stages["props"])
    with torch.no_grad():
        logits, deltas = port.box_branch(feats, props)
    v = stages["pvalid"]
    # f32 dense layers over 12544 inputs, summed in another order
    np.testing.assert_allclose(logits.numpy()[v], stages["logits"][v], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(deltas.numpy()[v], stages["deltas"][v], rtol=1e-4, atol=1e-4)
    # postprocess fed JAX's own head outputs
    det = postprocess_detections(torch.from_numpy(stages["logits"]),
                                 torch.from_numpy(stages["deltas"]), props,
                                 torch.from_numpy(v), torch.from_numpy(sizes),
                                 CFG.roi_heads, fallback_score=0.1)
    jd = stages["det"]
    np.testing.assert_array_equal(det.valid.numpy(), jd.valid)
    dv = jd.valid
    np.testing.assert_array_equal(det.labels.numpy()[dv], jd.labels[dv])
    np.testing.assert_allclose(det.scores.numpy(), jd.scores, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(det.boxes.numpy()[dv], jd.boxes[dv], rtol=1e-6, atol=1e-4)


def test_match_and_aggregator_descriptors_match_jax(models, stages):
    _, _, port, _, _ = models
    feats = [nchw(f) for f in stages["feats"]]
    boxes = torch.from_numpy(stages["det"].boxes)
    with torch.no_grad():
        roi14 = port._roi_align(feats, boxes, 14)
        match = port.match_descriptors(roi14)
        aggr = port.aggregator_descriptors(roi14)
    # boxes of a 96x128 image: sample coordinates < 32 cells, rounding alike
    np.testing.assert_allclose(nhwc(roi14), stages["roi14"], rtol=1e-5, atol=1e-5)
    # descriptors are O(1); f32 convs in another summation order
    np.testing.assert_allclose(match.numpy(), stages["match"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aggr.numpy(), stages["aggr"], rtol=1e-4, atol=1e-4)
