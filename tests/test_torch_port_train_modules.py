"""The phase-1 training modules of the port against the JAX package, one at a
time, on the CPU: targets, detector and match losses, match-slot selection,
the masked BatchNorm in training, the mask head, the optimizer's schedule
and trainable set.

Inputs are made from a seed with numpy; where the JAX function draws from a
key, the port is handed the same uniforms (``jax.random.uniform(key, (n,))``,
which is what the JAX sampler draws).  f32 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.config import ModelConfig, RoIHeadsConfig
from seam_match_rcnn_tpu.losses import detection as jdet
from seam_match_rcnn_tpu.losses import match as jmatch
from seam_match_rcnn_tpu.models.match_head import MaskedBatchNorm1d as JaxBN
from seam_match_rcnn_tpu.models.matchrcnn import MatchRCNN as JaxMatchRCNN
from seam_match_rcnn_tpu.models.matchrcnn import _select_match_slots as jax_slots
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.ops.boxes import box_iou as jax_iou
from seam_match_rcnn_tpu.ops import targets as jtargets
from seam_match_rcnn_tpu.train.optim import backbone_frozen_mask as jax_frozen_mask
from seam_match_rcnn_tpu.train.optim import multistep_warmup_schedule as jax_schedule

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.losses import detection as det
from seam_match_rcnn_tpu_torch.losses import match as match_losses
from seam_match_rcnn_tpu_torch.models.match_head import MaskedBatchNorm1d
from seam_match_rcnn_tpu_torch.models.matchrcnn import _select_match_slots, init_model
from seam_match_rcnn_tpu_torch.ops import targets
from seam_match_rcnn_tpu_torch.ops.boxes import box_iou
from seam_match_rcnn_tpu_torch.train.optim import (backbone_frozen_mask,
                                                   multistep_warmup_schedule, sgd)

torch.set_num_threads(2)
T = torch.from_numpy


def _boxes(rng, n, size=96.0, lo=4.0, hi=48.0):
    x1, y1 = rng.uniform(0, size - hi, n), rng.uniform(0, size - hi, n)
    w, h = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _jitter(rng, gts, n):
    """n proposals around the GTs (varied IoU) plus a few random ones."""
    base = gts[rng.randint(0, len(gts), n)]
    wh = np.concatenate([base[:, 2:] - base[:, :2]] * 2, -1)
    return (base + rng.uniform(-0.4, 0.4, base.shape) * wh).astype(np.float32)


# ---- targets -------------------------------------------------------------

@pytest.mark.parametrize("allow", [False, True])
def test_match_proposals_matches_jax(allow):
    rng = np.random.RandomState(int(allow))
    gts = np.stack([_boxes(rng, 5) for _ in range(2)])
    props = np.stack([_jitter(rng, g, 200) for g in gts])
    props[0, :3] = gts[0, :3]  # exact ties with a GT's best quality
    gt_valid = np.asarray([[True] * 5, [True, True, True, False, False]])
    want = np.stack([np.asarray(jtargets.match_proposals(
        jax_iou(jnp.asarray(gts[i]), jnp.asarray(props[i])), jnp.asarray(gt_valid[i]),
        0.7, 0.3, allow)) for i in range(2)])
    got = targets.match_proposals(box_iou(T(gts), T(props)), T(gt_valid), 0.7, 0.3,
                                  allow).numpy()
    assert (got >= 0).any() and (got == targets.BELOW_LOW_THRESHOLD).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pos,n_neg,n_ign,batch,frac", [
    (30, 400, 20, 128, 0.25), (300, 100, 0, 128, 0.25), (4, 2, 50, 16, 0.5),
    (0, 5000, 100, 512, 0.25)])
def test_balanced_sample_matches_jax(n_pos, n_neg, n_ign, batch, frac):
    rng = np.random.RandomState(n_pos + n_neg)
    labels = np.asarray([1] * n_pos + [0] * n_neg + [-1] * n_ign)
    labels = np.stack([rng.permutation(labels) for _ in range(2)])
    keys = jax.random.split(jax.random.PRNGKey(n_neg), 2)
    want = [jtargets.balanced_sample(jnp.asarray(labels[i]), keys[i], batch, frac)
            for i in range(2)]
    r = np.stack([np.asarray(jax.random.uniform(k, (labels.shape[1],))) for k in keys])
    got = targets.balanced_sample(T(labels), T(r), batch, frac)
    for i in range(2):
        np.testing.assert_array_equal(got.idx[i].numpy(), np.asarray(want[i].idx))
        np.testing.assert_array_equal(got.is_pos[i].numpy(), np.asarray(want[i].is_pos))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want[i].valid))


def test_assign_and_sample_matches_jax():
    rng = np.random.RandomState(7)
    b, g, n = 2, 4, 300
    gts = np.stack([_boxes(rng, g) for _ in range(b)])
    props = np.stack([_jitter(rng, gts[i], n) for i in range(b)])
    pvalid = rng.rand(b, n) > 0.1
    labels = rng.randint(1, 14, (b, g))
    gvalid = np.asarray([[True] * g, [True, True, False, False]])
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    r = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    got = targets.assign_and_sample(T(props), T(pvalid), T(gts), T(labels), T(gvalid), T(r),
                                    64, 0.25, 0.5, 0.5)
    for i in range(b):
        m, lab, s = jtargets.assign_and_sample(
            jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(gts[i]),
            jnp.asarray(labels[i]), jnp.asarray(gvalid[i]), keys[i], 64, 0.25, 0.5, 0.5)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(m))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(lab))
        np.testing.assert_array_equal(got[2].idx[i].numpy(), np.asarray(s.idx))
        np.testing.assert_array_equal(got[2].valid[i].numpy(), np.asarray(s.valid))
        assert got[2].is_pos[i].sum() > 0


# ---- losses --------------------------------------------------------------

def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def test_fastrcnn_and_smooth_l1_match_jax():
    rng = np.random.RandomState(0)
    n, c = 64, 14
    logits = rng.randn(n, c).astype(np.float32)
    deltas = rng.randn(n, 4 * c).astype(np.float32)
    labels = rng.randint(0, c, n)
    tgt = rng.randn(n, 4).astype(np.float32) * 0.2
    valid = rng.rand(n) > 0.2
    want = jdet.fastrcnn_loss_parts(*map(jnp.asarray, (logits, deltas, labels, tgt, valid)))
    got = det.fastrcnn_loss_parts(T(logits), T(deltas), T(labels), T(tgt), T(valid))
    for a, b in zip(got, want):
        _close(a, b)
    x = rng.randn(100).astype(np.float32) * 0.2
    _close(det.smooth_l1(T(x)), jdet.smooth_l1(jnp.asarray(x)))


def test_mask_loss_and_targets_match_jax():
    rng = np.random.RandomState(1)
    b, g, p, s = 2, 3, 10, 56
    gts = np.stack([_boxes(rng, g) for _ in range(b)])
    crops = (rng.rand(b, g, s, s) > 0.5).astype(np.float32)
    props = np.stack([_jitter(rng, gts[i], p) for i in range(b)])
    matched = rng.randint(0, g, (b, p))
    want_t = np.stack([np.asarray(jdet.mask_targets_from_crops(
        jnp.asarray(crops[i]), jnp.asarray(gts[i]), jnp.asarray(props[i]),
        jnp.asarray(matched[i]))) for i in range(b)])
    got_t = det.mask_targets_from_crops(T(crops), T(gts), T(props), T(matched))
    assert got_t.shape == (b, p, 28, 28)
    _close(got_t, want_t)
    logits = rng.randn(b * p, 28, 28, 14).astype(np.float32)
    labels = rng.randint(0, 14, b * p)
    valid = rng.rand(b * p) > 0.3
    want = jdet.maskrcnn_loss_parts(jnp.asarray(logits), jnp.asarray(want_t.reshape(-1, 28, 28)),
                                    jnp.asarray(labels), jnp.asarray(valid))
    got = det.maskrcnn_loss_parts(T(logits).permute(0, 3, 1, 2), got_t.reshape(-1, 28, 28),
                                  T(labels), T(valid))
    for a, bb in zip(got, want):
        _close(a, bb)


def test_rpn_loss_matches_jax():
    rng = np.random.RandomState(2)
    b, g = 2, 4
    anchors = np.concatenate([_jitter(rng, _boxes(rng, 30), 600), _boxes(rng, 400)])
    n = anchors.shape[0]
    gts = np.stack([_boxes(rng, g) for _ in range(b)])
    gvalid = np.asarray([[True] * g, [True, True, True, False]])
    obj = rng.randn(b, n).astype(np.float32)
    deltas = (rng.randn(b, n, 4) * 0.1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    r = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    lo, lb = det.rpn_loss(T(obj), T(deltas), T(anchors), T(gts), T(gvalid), T(r), 256, 0.5,
                          0.7, 0.3)
    for i in range(b):
        wo, wb = jdet.rpn_loss(jnp.asarray(obj[i]), jnp.asarray(deltas[i]), jnp.asarray(anchors),
                               jnp.asarray(gts[i]), jnp.asarray(gvalid[i]), keys[i], 256, 0.5,
                               0.7, 0.3)
        _close(lo[i], wo)
        _close(lb[i], wb)
        assert float(wb) > 0


def test_match_loss_supervised_matches_jax():
    rng = np.random.RandomState(3)
    n = 16
    logits = rng.randn(n, n, 2).astype(np.float32) * 3
    pairs, styles = rng.randint(1, 4, n), rng.randint(0, 3, n)
    src = rng.rand(n) > 0.5
    valid = rng.rand(n) > 0.2
    for scale in (1.0, 0.05):  # above and below the damping threshold
        args = (logits * scale, pairs, styles, pairs, styles, valid & ~src, valid & src)
        want = jmatch.match_loss_supervised(*map(jnp.asarray, args))
        got = match_losses.match_loss_supervised(*map(T, args))
        _close(got, want)


# ---- match-slot selection --------------------------------------------------

@pytest.mark.parametrize("p,g,k,dup", [(20, 3, 8, False), (128, 3, 100, False),
                                       (128, 2, 120, True), (64, 24, 8, False)])
def test_select_match_slots_matches_jax(p, g, k, dup):
    """Includes slot sets spanning more than 64 candidate cells, where the
    JAX package's f32 keys 1e9 - i tie in runs of 64, and tied IoUs."""
    rng = np.random.RandomState(p + g + k)
    b = 2
    gts = np.stack([_boxes(rng, g) for _ in range(b)])
    props = np.stack([_jitter(rng, gts[i], p) for i in range(b)])
    if dup:
        props[:, 1::2] = props[:, 0::2]  # every IoU appears twice
    pvalid = rng.rand(b, p) > 0.2
    gvalid = np.ones((b, g), bool)
    gvalid[1, g // 2:] = False
    got_idx, got_valid = _select_match_slots(T(props), T(pvalid), T(gts), T(gvalid), k)
    for i in range(b):
        idx, valid = jax_slots(jnp.asarray(props[i]), jnp.asarray(pvalid[i]), jnp.asarray(gts[i]),
                               jnp.asarray(gvalid[i]), k)
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_valid[i].numpy(), np.asarray(valid))
    if k > 64:
        assert int(got_valid.sum()) > 64


# ---- masked BatchNorm in training ------------------------------------------

@pytest.mark.parametrize("case", ["masked", "all_valid", "none_valid", "no_mask"])
def test_masked_batchnorm_training_matches_jax(case):
    rng = np.random.RandomState(["masked", "all_valid", "none_valid", "no_mask"].index(case))
    n, c = 24, 16
    x = (rng.randn(n, c) * 2 + 1).astype(np.float32)
    valid = {"masked": rng.rand(n) > 0.4, "all_valid": np.ones(n, bool),
             "none_valid": np.zeros(n, bool), "no_mask": None}[case]
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.5
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    vj = None if valid is None else jnp.asarray(valid)
    want, mut = JaxBN().apply(variables, jnp.asarray(x), train=True, valid=vj,
                              mutable=["batch_stats"])
    bn = MaskedBatchNorm1d(c)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
    got = bn(T(x), valid=None if valid is None else T(valid), train=True)
    _close(got.detach(), want)
    _close(bn.running_mean, mut["batch_stats"]["mean"])
    _close(bn.running_var, mut["batch_stats"]["var"])
    if case == "none_valid":
        np.testing.assert_array_equal(bn.running_mean.numpy(), mean0)
    # inference uses the running statistics
    want_eval = JaxBN().apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                              jnp.asarray(x), train=False)
    _close(bn(T(x)).detach(), want_eval)


# ---- heads, match loss and optimizer on shared weights ----------------------

@pytest.fixture(scope="module")
def shared():
    cfg = ModelConfig(roi_heads=RoIHeadsConfig(roi_align_backend="pallas_resident"),
                      compute_dtype="float32", stem_backend="pallas",
                      freeze_backbone_stages=True)
    jmodel, variables = jax_init(cfg, video=False, canvas=(64, 64))
    variables = jax.tree.map(np.asarray, variables)
    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    return cfg, jmodel, variables, port


def test_mask_head_matches_jax(shared):
    _, jmodel, variables, port = shared
    rng = np.random.RandomState(4)
    x = rng.randn(3, 14, 14, 256).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), method=JaxMatchRCNN.mask_branch)
    got = port.mask_branch(T(x).permute(0, 3, 1, 2))
    assert got.shape == (3, 14, 28, 28)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_match_loss_from_rois_and_bn_stats_match_jax(shared):
    _, jmodel, variables, port = shared
    rng = np.random.RandomState(5)
    n = 16
    rois = (rng.randn(n, 14, 14, 256) * 0.5).astype(np.float32)
    meta = {"pair_ids": rng.randint(1, 3, n), "styles": rng.randint(0, 3, n),
            "src": np.asarray([0, 1] * (n // 2)), "valid": rng.rand(n) > 0.25}
    want, mut = jmodel.apply(variables, jnp.asarray(rois), {k: jnp.asarray(v) for k, v in
                                                            meta.items()},
                             method=JaxMatchRCNN.match_loss_from_rois, mutable=["batch_stats"])
    bn = port.roi_heads["match_predictor"].linear[1]
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    got = port.match_loss_from_rois(T(rois).permute(0, 3, 1, 2), {k: T(v) for k, v in
                                                                   meta.items()})
    _close(got.detach(), want, tol=1e-4)
    stats = mut["batch_stats"]["match_predictor"]["trunk"]["bn"]
    _close(bn.running_mean, stats["mean"], tol=1e-4)
    _close(bn.running_var, stats["var"], tol=1e-4)
    with torch.no_grad():
        bn.running_mean.copy_(mean0)
        bn.running_var.copy_(var0)


def test_trainable_set_and_schedule_match_jax(shared):
    _, _, variables, port = shared
    jmask = jax_frozen_mask(variables["params"])
    n_jax = sum(int(np.prod(np.shape(leaf))) for leaf, keep in
                zip(jax.tree.leaves(variables["params"]), jax.tree.leaves(jmask)) if keep)
    mask = backbone_frozen_mask(port)
    n_port = sum(p.numel() for name, p in port.named_parameters() if mask[name])
    assert n_port == n_jax
    opt = sgd(port, lambda s: 0.02)
    assert sum(p.numel() for p in opt.params) == n_jax  # frozen stem/layer1 left out
    assert not any(p.requires_grad for p in port.backbone.body.layer1.parameters())
    for args in [(0.02, (6, 9), 0.1, 1000, 1000, 1e-3), (1.0, (2, 4), 0.1, 10, 5, 0.1),
                 (0.5, (1,), 0.1, 1, 1000, 1e-3)]:
        sj, sp = jax_schedule(*args), multistep_warmup_schedule(*args)
        for step in (0, 1, 3, 5, 9, 10, 15, 25, 45, 999, 1000, 6000, 9001):
            assert sp(step) == pytest.approx(float(sj(step)), rel=1e-6)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_sgd_with_decay_and_clipping_matches_optax(clip):
    """Two updates of the port's SGD (weight decay, momentum, optional
    global-norm clipping) against the JAX package's optax chain."""
    import optax
    from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd
    from seam_match_rcnn_tpu_torch.train.optim import SGD

    rng = np.random.RandomState(6)
    p0 = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 2).astype(np.float32) for k, v in p0.items()}
             for _ in range(2)]
    sched = lambda s: 0.1 / (1 + s)  # noqa: E731
    tx = jax_sgd(sched, momentum=0.9, weight_decay=1e-2, clip_grad_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    ps = {k: torch.nn.Parameter(T(v.copy())) for k, v in p0.items()}
    opt = SGD(ps.values(), sched, momentum=0.9, weight_decay=1e-2, clip_grad_norm=clip)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, p in ps.items():
            p.grad = T(g[k].copy())
        opt.step()
    for k in p0:
        _close(ps[k].detach(), jp[k], tol=1e-6)
    assert opt.count == 2
