"""The port's phase-2 match losses against the JAX package's: the weak
labels (their segment argmax with ties, all-masked groups and an
all-masked grid), MatchLossWeak, the aggregation loss (class weights 1.0
and 0.3) and MatchLossDF2, on the same inputs drawn from a seed.  Labels
must be equal, losses within rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seam_match_rcnn_tpu.losses import match as jax_match

from seam_match_rcnn_tpu_torch.losses import match

t = torch.from_numpy


def _grid(seed, n=12, m=3, n_images=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, m, 2).astype(np.float32)
    img = rng.randint(0, n_images, n).astype(np.int32)
    col = rng.randint(-1, m, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    return logits, img, col, valid


def _labels(logits, img, col, valid, n_images, thr=-10.0):
    got = match.weak_match_labels(t(logits), t(img), t(col), t(valid), n_images, thr)
    want = jax_match.weak_match_labels(jnp.asarray(logits), jnp.asarray(img), jnp.asarray(col),
                                       jnp.asarray(valid), n_images, thr)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weak_labels_match_jax(seed):
    logits, img, col, valid = _grid(seed)
    got, want = _labels(logits, img, col, valid, 4)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_weak_labels_ties_go_to_the_first_row():
    """Rows 2, 5 and 7 of image 1 tie at the group's maximum: row 2 wins, as
    torch argmax; image 0's tie between rows 0 and 3 sits below the
    threshold, so it has no winner."""
    logits, img, col, valid = _grid(3, n=8, m=2, n_images=2)
    img[:] = [0, 1, 1, 0, 1, 1, 0, 1]
    col[:] = 1
    valid[:] = True
    logits[..., 1] = -20.0
    logits[[2, 5, 7], 1, 1] = 3.0
    logits[[0, 3], 1, 1] = -15.0
    got, want = _labels(logits, img, col, valid, 2)
    np.testing.assert_array_equal(got, want)
    assert got[:, 1].tolist() == [0, 0, 1, 0, 0, 0, 0, 0]


def test_weak_labels_of_masked_rows_and_grid():
    """Rows that are invalid or lack a shop column go to the spare group and
    never win, also when they hold the highest logit; an all-masked grid
    has no positive."""
    logits, img, col, valid = _grid(4)
    logits[0, :, 1] = 50.0
    valid[0] = False
    logits[1, :, 1] = 50.0
    col[1] = -1
    got, want = _labels(logits, img, col, valid, 4)
    np.testing.assert_array_equal(got, want)
    assert got[:2].sum() == 0
    got, want = _labels(logits, img, col, np.zeros_like(valid), 4)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 0


@pytest.mark.parametrize("masked", [False, True])
def test_weak_and_aggregation_losses_match_jax(masked):
    logits, img, col, valid = _grid(5, n=12, m=4)
    shop_valid = np.asarray([True, False, True, True])
    if masked:
        valid[:] = False
    gts = jax_match.weak_match_labels(jnp.asarray(logits), jnp.asarray(img), jnp.asarray(col),
                                      jnp.asarray(valid), 4)
    for name in ("match_loss_weak", "aggregation_loss"):
        want = float(getattr(jax_match, name)(jnp.asarray(logits), gts, jnp.asarray(valid),
                                              jnp.asarray(shop_valid)))
        got = float(getattr(match, name)(t(logits), t(np.array(gts)).to(torch.int64),
                                         t(valid), t(shop_valid)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), name
        if masked:
            assert got == 0.0


def test_aggregation_loss_weighs_positives_0_3():
    """On the eye grid of the aggregator, with every pair valid."""
    rng = np.random.RandomState(6)
    logits = rng.randn(5, 5, 2).astype(np.float32)
    gts = np.eye(5, dtype=np.int64)
    ok = np.ones(5, bool)
    got = float(match.aggregation_loss(t(logits), t(gts), t(ok), t(ok)))
    want = float(jax_match.aggregation_loss(jnp.asarray(logits), jnp.asarray(gts),
                                            jnp.asarray(ok), jnp.asarray(ok)))
    lg = t(logits)
    ce = torch.logsumexp(lg, -1) - torch.where(t(gts) == 1, lg[..., 1], lg[..., 0])
    w = torch.where(t(gts) == 1, 0.3, 1.0)
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(float((ce * w).sum() / w.sum()), rel=1e-6)


def test_match_loss_df2_matches_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(9, 6, 2).astype(np.float32)
    street, shop = rng.randint(0, 4, 9), rng.randint(0, 4, 6)
    sv, hv = rng.rand(9) > 0.3, rng.rand(6) > 0.3
    want = float(jax_match.match_loss_df2(jnp.asarray(logits), jnp.asarray(street),
                                          jnp.asarray(shop), jnp.asarray(sv), jnp.asarray(hv)))
    got = float(match.match_loss_df2(t(logits), t(street), t(shop), t(sv), t(hv)))
    assert got == pytest.approx(want, rel=1e-6)
