"""The port's phase-2 head steps against the JAX package's
(``train/seam.py``), on the CPU at a small size: K = 16 rows, 3 products,
3-4 frames, the trunks at their fixed 256/1024 widths.  Both sides start
from the same head weights and take the same rows of the same RoI features.

Tolerances: the weak structures are equal; the losses within rtol 1e-4;
each parameter's update within 5e-3 of the JAX update's norm and the
BatchNorm statistics within rtol 1e-4, atol 1e-5
(``torch_port_seam_common.assert_heads_close``, phase 1's rule).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.train import seam as jax_seam

from seam_match_rcnn_tpu_torch.ops import cuda_kernels
from seam_match_rcnn_tpu_torch.train import seam
from torch_port_seam_common import (LR, WD, assert_heads_close, head_tree, jax_tx, make_heads,
                                    port_sgd, roi_features, state_copy)

torch.set_num_threads(2)

N_IMG, D, T, P, K = 12, 3, 3, 3, 16


def _weak_inputs():
    """tests/test_weak_structures.py's layout: row 0 wins its group, product 2
    has no shop, slot 1 of product 0 is empty."""
    rng = np.random.RandomState(0)
    logits = rng.randn(10, 3, 2).astype(np.float32)
    types = np.asarray([0, 0, 1, 0, 0, 1, 0, 0, 0, 0], np.int32)
    prod = np.asarray([0, 0, 0, 1, 1, 1, 2, 2, 2, 2], np.int32)
    img_slot = np.asarray([0, 0, 0, 2, 3, 0, 4, 4, 5, 5], np.int32)
    shop_row = np.asarray([2, 5, -1], np.int32)
    logits[0, 0, 1], logits[1, 0, 1] = 5.0, 1.0
    return logits, np.ones(10, bool), types, prod, img_slot, shop_row


def _weak_both(logits, valid, types, prod, img_slot, shop_row, t_max, n_frames, thr=-10.0):
    got = seam.build_weak_structures(*[torch.from_numpy(a) for a in (
        logits, valid, types, prod, img_slot, shop_row)], t_max, n_frames, thr)
    want = jax_seam.build_weak_structures(*[jnp.asarray(a) for a in (
        logits, valid, types, prod, img_slot, shop_row)], t_max=t_max, n_frames=n_frames,
        match_threshold=thr)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n_frames", [1, 2])
def test_weak_structures_match_jax_with_row0_winner_and_empty_group(n_frames):
    """Row 0 wins its slot while slot 1 of product 0 and product 2 (no shop)
    have no winner: their scatters must not reach row 0."""
    got, want = _weak_both(*_weak_inputs(), t_max=2, n_frames=n_frames)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gts"][0, 0] == 1 and got["win_of_row"][0]


def test_weak_structures_threshold_blocks_all():
    logits = np.full((4, 2, 2), -50.0, np.float32)
    got, want = _weak_both(logits, np.ones(4, bool), np.asarray([0, 0, 1, 1], np.int32),
                           np.asarray([0, 0, 0, 1], np.int32), np.asarray([0, 0, 0, 1], np.int32),
                           np.asarray([2, 3], np.int32), t_max=1, n_frames=1)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gts"].sum() == 0 and not got["seq_ok"].any() and not got["ta_bn_valid"].any()


def test_group_winners_match_jax():
    rng = np.random.RandomState(1)
    score = rng.randn(20).astype(np.float32)
    score[[3, 11]] = score.max() + 1.0  # a tie in one group
    grp = rng.randint(0, 6, 20).astype(np.int32)
    grp[[3, 11]] = 2
    ok = rng.rand(20) > 0.3
    ok[[3, 11]] = True
    ok[grp == 5] = False  # a group with no ok row
    got = seam._group_winners(torch.from_numpy(score), torch.from_numpy(grp),
                              torch.from_numpy(ok), 6)
    want = jax_seam._group_winners(jnp.asarray(score), jnp.asarray(grp), jnp.asarray(ok), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][2]) == 3 and not bool(got[1][5])


def _outputs(rng):
    """Runner outputs of 3 products x (1 shop + 3 frames): D = 3 detections
    an image, scores drawn so that some fall below 0.5."""
    outs = []
    for _ in range(N_IMG):
        boxes = np.sort(rng.uniform(0, 100, (D, 4)).astype(np.float32).reshape(D, 2, 2),
                        axis=1).transpose(0, 2, 1).reshape(D, 4)
        outs.append({"scores": rng.uniform(0.2, 1.0, D).astype(np.float32), "boxes": boxes,
                     "valid": np.ones(D, bool)})
    return outs


def mf_batch(seed=0):
    """One MovingFashion head batch in both layouts: (port dict, JAX dict)."""
    rng = np.random.RandomState(seed)
    tags = [1, 0, 0, 0] * P
    prods = [p for p in range(P) for _ in range(1 + T)]
    sel = jax_seam.select_rows_host(_outputs(rng), tags, prods, 0.5, P, T, K)
    assert sel is not None and sel.valid.sum() > 8
    roi = roi_features(rng, N_IMG, D)
    keys = ("row_img", "row_det", "valid", "types", "prod", "img_slot", "shop_row")
    port = {k: torch.from_numpy(getattr(sel, k)) for k in keys}
    port["roi_src"] = torch.from_numpy(roi)
    ref = {k: jnp.asarray(getattr(sel, k)) for k in keys}
    ref["roi_src"] = jnp.asarray(roi.transpose(0, 1, 3, 4, 2))
    return port, ref


@pytest.fixture(scope="module")
def jax_mf_step():
    return jax_seam.make_seam_head_step(jax_tx(), frames_per_product=T, n_frames=2)


def _port_mf_step(mp, ta):
    opt = port_sgd(list(mp.parameters()) + list(ta.parameters()))
    return seam.make_seam_head_step(mp, ta, opt, frames_per_product=T, n_frames=2)


@pytest.mark.parametrize("epoch", [0, 1])
def test_movingfashion_head_steps_match_jax(jax_mf_step, epoch):
    """Two steps at the epoch's aggregation weight, min(epoch, 1), the
    second on another batch and with momentum."""
    mp, ta = make_heads(0, nlb_backend="pallas")  # the serving build: the step asks for "xla"
    variables = head_tree(mp, ta)
    state = jax_seam.create_head_state(variables, jax_tx())
    step = _port_mf_step(mp, ta)
    w = float(min(epoch, 1))
    for seed in (1, 2):
        port, ref = mf_batch(seed)
        port["aggr_weight"], ref["aggr_weight"] = torch.tensor(w), jnp.asarray(w, jnp.float32)
        got = step(port)
        state, want = jax_mf_step(state, ref)
        for k in ("match_loss", "aggregation_loss", "loss"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), (seed, k)
        assert float(got["aggregation_loss"]) > 0
    worst = assert_heads_close(mp, ta, variables["params"], state.params, state.batch_stats)
    print(f"epoch {epoch}: worst leaf update error {worst:.3g} of its size")


def test_epoch0_still_runs_the_aggregator():
    """At aggregation weight 0 the aggregator's forward stays in the graph:
    its BatchNorm statistics move, and its zero gradients reach the
    optimizer, whose weight decay moves every parameter by -lr wd p (the
    first step has no momentum).  A step that skipped the aggregator would
    leave it as it was."""
    mp, ta = make_heads(3)
    (ta0,) = state_copy(ta)
    port, _ = mf_batch(1)
    port["aggr_weight"] = torch.tensor(0.0)
    _port_mf_step(mp, ta)(port)
    for name, p in ta.named_parameters():
        assert not torch.equal(p, ta0[name]), name
        want = (ta0[name].double() * (1 - LR * WD)).float()
        torch.testing.assert_close(p.detach(), want, rtol=3e-7, atol=1e-12, msg=name)
    for name in ("running_mean", "running_var"):
        assert not torch.equal(getattr(ta.linear[1], name), ta0[f"linear.1.{name}"]), name


def mdf2_batch(seed):
    """A MultiDF2 head batch: product 0 with 4 street rows, product 1 with 3
    (both >= 3 views), product 2 with 2 (no aggregation target), each with
    its shop row; rows 12-15 padding."""
    rng = np.random.RandomState(seed)
    shop_row = np.asarray([0, 5, 9], np.int32)
    seq_gather = np.zeros((P, 4), np.int32)
    seq_mask = np.zeros((P, 4), bool)
    for p, rows in enumerate(([1, 2, 3, 4], [6, 7, 8], [10, 11])):
        seq_gather[p, :len(rows)] = rows
        seq_mask[p, :len(rows)] = True
    row_img = rng.randint(0, N_IMG, K).astype(np.int32)
    row_det = rng.randint(0, D, K).astype(np.int32)
    roi = roi_features(rng, N_IMG, D)
    arrays = {"row_img": row_img, "row_det": row_det, "shop_row": shop_row,
              "seq_gather": seq_gather, "seq_mask": seq_mask}
    port = {k: torch.from_numpy(v) for k, v in arrays.items()}
    port["roi_src"] = torch.from_numpy(roi)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    ref["roi_src"] = jnp.asarray(roi.transpose(0, 1, 3, 4, 2))
    return port, ref


def test_multidf2_head_steps_match_jax():
    """Two steps: the aggregator trains as in JAX; the match predictor's
    parameters and statistics stay bit-equal on both sides."""
    mp, ta = make_heads(1, nlb_backend="pallas")
    (mp0,) = state_copy(mp)
    variables = head_tree(mp, ta)
    state = jax_seam.create_head_state(variables, jax_tx())
    jax_step = jax_seam.make_mdf2_head_step(jax_tx())
    step = seam.make_mdf2_head_step(ta, port_sgd(ta.parameters()))
    for seed in (3, 4):
        port, ref = mdf2_batch(seed)
        got = step(port)
        state, want = jax_step(state, ref)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
        assert float(got["loss"]) > 0
    assert_heads_close(mp, ta, variables["params"], state.params, state.batch_stats)
    for k, v in mp.state_dict().items():
        assert torch.equal(v, mp0[k]), k
    for a, b in zip(jax.tree.leaves(state.params["match_predictor"]),
                    jax.tree.leaves(variables["params"]["match_predictor"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multidf2_step_refuses_an_optimizer_over_the_match_predictor():
    mp, ta = make_heads(2)
    with pytest.raises(ValueError, match="aggregator's parameters only"):
        seam.make_mdf2_head_step(ta, port_sgd(list(mp.parameters()) + list(ta.parameters())))


def test_k3_wrapper_raises_when_autograd_needs_it():
    """K3 has no backward: its wrapper refuses a call that autograd would
    have to differentiate (seqs or a weight requiring grad, grad mode on),
    rather than return an output cut from the graph; under no_grad it runs,
    and the torch-ops aggregation trains."""
    _, ta = make_heads(4, nlb_backend="pallas")
    rng = np.random.RandomState(5)
    seqs = torch.from_numpy(rng.randn(2, 4, 256).astype(np.float32))
    mask = torch.tensor([[True] * 4, [True, True, False, False]])
    with pytest.raises(RuntimeError, match="no backward"):
        ta.aggregate(seqs, mask)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_kernels.nlb_aggregate(seqs.requires_grad_(True), mask,
                                   {k: v.detach() for k, v in ta.nlb_weights().items()})
    with torch.no_grad():
        served = ta.aggregate(seqs, mask)
    trained = ta.aggregate(seqs, mask, nlb_backend="xla")
    torch.testing.assert_close(trained.detach(), served, rtol=1e-5, atol=1e-5)
    trained.sum().backward()
    assert ta.newnlb.theta.weight.grad is not None and seqs.grad is not None
