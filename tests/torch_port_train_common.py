"""Shared set-up of the port's phase-1 step tests against the JAX package:
the tiny serving-profile configuration, batches in both layouts, the
samplers' draws taken from the JAX key tree, and the comparison of the
trained states."""

import numpy as np
import torch

import jax

from seam_match_rcnn_tpu.ckpt.torch_convert import convert_state_dict
from seam_match_rcnn_tpu.config import ModelConfig, RoIHeadsConfig, RPNConfig
from seam_match_rcnn_tpu.models.anchors import grid_anchors

from seam_match_rcnn_tpu_torch.models.layers import FrozenBatchNorm2d

LOSS_KEYS = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
             "loss_mask", "loss_match", "loss")


def serving_train_cfg(rpn_batch=32, roi_batch=64, pre=100, post=150, positive_fraction=0.25,
                      stem_backend="xla"):
    """The phase-1 serving profile (tile-resident RoIAlign with its adjoint
    kernel, frozen stem and layer1) at tiny sizes, f32.  The stem is the XLA
    one by default: the JAX package's ``make_phase1_step`` cannot trace its
    fused Pallas stem (``pallas_call`` has no JVP rule there; ROADMAP
    F-ref-3), so the step comparisons run both sides on the f32 stem."""
    return ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_train=pre, post_nms_top_n_train=post,
                      pre_nms_top_n_test=50, post_nms_top_n_test=80,
                      batch_size_per_image=rpn_batch),
        roi_heads=RoIHeadsConfig(batch_size_per_image=roi_batch, detections_per_img=10,
                                 positive_fraction=positive_fraction,
                                 roi_align_backend="pallas_resident"),
        compute_dtype="float32", stem_backend=stem_backend, freeze_backbone_stages=True)


def randomize_biases(variables, seed=0):
    """The JAX variables with every bias drawn from N(0, 0.01) instead of 0.

    At initialisation a RoI whose features are all 0 after the ReLUs gets a
    mask logit of exactly 0 (the zero bias).  There the two packages' BCE
    gradients differ: the port's is sigmoid(0) - y, the true derivative (as
    torch's BCE-with-logits), while the JAX package's is -y, since
    jax.grad(jnp.abs)(0.) is 1 (ROADMAP F-ref-4).  Non-zero biases keep
    every logit off that point."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return (rng.randn(*np.shape(leaf)) * 0.01).astype(np.float32)
        return np.asarray(leaf)

    return {"params": jax.tree_util.tree_map_with_path(fill, variables["params"]),
            "batch_stats": jax.tree.map(np.asarray, variables.get("batch_stats", {}))}


def to_port_batch(batch):
    """A JAX batch (images NHWC) -> the port's (images NCHW, int64 labels)."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    gt = {k: t(v) for k, v in batch["gt"].items()}
    for k in ("labels", "pair_ids", "styles", "source"):
        gt[k] = gt[k].to(torch.int64)
    return {"images": t(batch["images"]).permute(0, 3, 1, 2).contiguous(),
            "sizes": t(batch["sizes"]), "gt": gt}


def split_batch(batch, lo, hi):
    return {"images": batch["images"][lo:hi], "sizes": batch["sizes"][lo:hi],
            "gt": jax.tree.map(lambda x: x[lo:hi], batch["gt"])}


def jax_draws(rng, cfg, batch):
    """The uniforms ``MatchRCNN._train_core`` of the JAX package draws from
    ``rng``: split(rng, 3), then split(., B) of [0] (RPN) and [1] (RoIs)."""
    b, h, w = batch["images"].shape[:3]
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] - 1) // 2 + 1, (shapes[-1][1] - 1) // 2 + 1))
    n_anchors = sum(len(a) for a in grid_anchors((h, w), tuple(shapes),
                                                 tuple(cfg.anchors.sizes),
                                                 tuple(cfg.anchors.aspect_ratios)))
    n_roi = cfg.rpn.post_nms_top_n_train + batch["gt"]["boxes"].shape[1]
    rngs = jax.random.split(rng, 3)
    draw = lambda key, n: torch.from_numpy(np.stack([  # noqa: E731
        np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key, b)]))
    return {"rpn": draw(rngs[0], n_anchors), "roi": draw(rngs[1], n_roi)}


def frozen_tensors(model):
    """Every frozen tensor of the port: stem and layer1 parameters, and all
    FrozenBatchNorm2d buffers."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()
           if n.startswith(("backbone.body.conv1.", "backbone.body.layer1."))}
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            for bn, buf in mod.named_buffers():
                out[f"{name}.{bn}"] = buf.detach().clone()
    return out


def assert_losses_close(got, want):
    for k in LOSS_KEYS:
        a, b = float(want[k]), float(got[k])
        assert abs(a - b) < 1e-4 * (1 + abs(a)), (k, a, b)


def assert_state_close(model, params0, params, batch_stats, rtol=5e-3):
    """The port's state after one step, mapped back with the JAX package's
    converter, against the JAX state; both started from ``params0``.

    Parameters: each leaf's update (after - before) against JAX's, as
    ||dp_port - dp_jax|| <= rtol * ||dp_jax|| + 1e-6 * (the norm of the whole
    JAX update), so every gradient is held relative to its own size, the
    small ones of layer2-4 and the FPN too.  The second term only admits
    rounding on the leaves whose gradient is exactly 0 (biases before the
    match trunk's BatchNorm, shifts cancelled by the pair score's
    differences).  rtol: at initialisation the f32 backward sends ulps of
    convolution rounding through ReLU gates and the match BatchNorm over a
    handful of slots; at lr 0.01 the worst leaf of the two step tests
    differs by 9.2e-4 of its size from the JAX package's, and the port's
    own update moves by 3e-4 from one CPU thread count to another.  A
    missing, zeroed or rescaled gradient shows as an error near 1.  BN
    statistics: rtol 1e-4, atol 1e-5 (tests/test_linked_step.py's).
    Returns the worst leaf's error over its size, which the tests print."""
    back = convert_state_dict({k: v.detach().numpy() for k, v in model.state_dict().items()})
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])  # noqa: E731
    got, before, want = flat(back["params"]), flat(params0), flat(params)
    assert len(got) == len(want)
    upd = {k: (np.asarray(got[k], np.float64) - np.asarray(before[k], np.float64),
               np.asarray(want[k], np.float64) - np.asarray(before[k], np.float64))
           for k in want}
    floor = 1e-6 * np.sqrt(sum(np.sum(dj ** 2) for _, dj in upd.values()))
    worst = 0.0
    for path, (dp, dj) in upd.items():
        err, size = np.linalg.norm(dp - dj), np.linalg.norm(dj)
        assert err <= rtol * size + floor, (jax.tree_util.keystr(path), err, size)
        if size > floor:
            worst = max(worst, err / size)
    got = flat(back["batch_stats"])
    leaves = jax.tree_util.tree_flatten_with_path(batch_stats)[0]
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(leaf), rtol=1e-4, atol=1e-5,
                                   err_msg=f"batch_stats{jax.tree_util.keystr(path)}")
    return worst
