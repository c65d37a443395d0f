"""The port's DeepFashion2 data layer against the JAX package, bit for bit.

``data/convert`` (the DeepFtoCoco converter), ``data/coco``,
``data/transforms`` (the flip under the same ``random.seed``),
``data/df2`` (``DeepFashion2Dataset`` items and the ``DF2PairBatchSampler``
batches over epochs, shards and ``drop_last``) and ``data/multidf2``
(``MultiDeepFashion2Dataset`` and its ``product_batches`` under shuffle,
shards, limits, ``skip_batches`` and noise drawn from the dataset's rng) on
a fixture the JAX package's synthetic maker writes: 4 products of 3 street
and 3 shop views, one product left with a single street view and one with
none, so that ``filter_onestreet`` and partnerless entries have work.
Exact equality throughout (numpy only).
"""

import inspect
import json
import os
import random

import numpy as np
import pytest

from seam_match_rcnn_tpu.cli import _args as jax_args
from seam_match_rcnn_tpu.data import coco as jax_coco
from seam_match_rcnn_tpu.data import convert as jax_convert
from seam_match_rcnn_tpu.data import df2 as jax_df2
from seam_match_rcnn_tpu.data import multidf2 as jax_multidf2
from seam_match_rcnn_tpu.data import synthetic as jax_synthetic
from seam_match_rcnn_tpu.data import transforms as jax_transforms

from seam_match_rcnn_tpu_torch.cli import _args, deepf_to_coco
from seam_match_rcnn_tpu_torch.data import coco, convert, df2, multidf2, transforms


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("df2")
    img_dir, ann_dir = jax_synthetic.make_synthetic_df2(
        str(root), n_products=4, views_per_side=3, image_size=(100, 130))
    # product 1 keeps one street view (filter_onestreet drops it), product 3
    # none (its shop images have no partner)
    for name in ("000007", "000008", "000019", "000020", "000021"):
        os.remove(os.path.join(ann_dir, name + ".json"))
    jax_ann, ann = str(root / "jax.json"), str(root / "port.json")
    jax_convert.convert(img_dir, ann_dir, jax_ann)
    deepf_to_coco.main(["--image_dir", img_dir, "--annos_dir", ann_dir, "--out", ann])
    return img_dir, ann_dir, jax_ann, ann


def assert_same(a, b, where="item"):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (where, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_converters_write_equal_annotations(fixture, tmp_path):
    img_dir, ann_dir, jax_ann, ann = fixture
    with open(jax_ann) as f, open(ann) as g:
        want, got = json.load(f), json.load(g)
    assert got == want
    assert len(got["images"]) == 19 and len(got["annotations"]) == 19
    # --limit, 0 included (convert nothing, not everything)
    for limit in (0, 5):
        a, b = str(tmp_path / f"j{limit}.json"), str(tmp_path / f"p{limit}.json")
        assert convert.convert(img_dir, ann_dir, b, limit=limit) == \
            jax_convert.convert(img_dir, ann_dir, a, limit=limit)


def test_copies_agree():
    body = lambda m: inspect.getsource(m).split('"""', 2)[2]  # noqa: E731
    assert body(coco) == body(jax_coco)
    assert body(transforms) == body(jax_transforms)
    for v in ("1", "true", "Yes", "on", "0", "False", "no", "OFF", "", " t ", "n"):
        assert _args.strtobool(v) == jax_args.strtobool(v)
    with pytest.raises(ValueError):
        _args.strtobool("maybe")


@pytest.mark.parametrize("full_masks", [False, True])
def test_dataset_items_equal(fixture, full_masks):
    img_dir, _, jax_ann, ann = fixture
    mine = df2.DeepFashion2Dataset(ann, img_dir, with_full_masks=full_masks)
    theirs = jax_df2.DeepFashion2Dataset(jax_ann, img_dir, with_full_masks=full_masks)
    for attr in ("ids", "street_inds", "shop_inds", "match_map_street", "match_map_shop",
                 "accepted_entries", "cat_to_contiguous", "idx_of_id"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert len(mine.accepted_entries) == 16  # product 3's three shop images have no partner
    for i in range(len(theirs)):
        assert_same(mine[i], theirs[i], f"item {i}")
        img_id = theirs.ids[i]
        assert mine.partners_in_shop(img_id) == theirs.partners_in_shop(img_id)
        assert mine.partners_in_street(img_id) == theirs.partners_in_street(img_id)


def test_flip_equal_under_the_same_seed(fixture):
    img_dir, _, jax_ann, ann = fixture
    mine = df2.DeepFashion2Dataset(ann, img_dir, transforms=transforms.Compose(
        [transforms.ToArray(), transforms.RandomHorizontalFlip(0.5)]), with_full_masks=True)
    theirs = jax_df2.DeepFashion2Dataset(jax_ann, img_dir, transforms=jax_transforms.Compose(
        [jax_transforms.ToArray(), jax_transforms.RandomHorizontalFlip(0.5)]),
        with_full_masks=True)

    def items(ds):
        random.seed(123)
        return [ds[i] for i in range(len(ds))]

    got, want = items(mine), items(theirs)
    assert_same(got, want)
    plain = df2.DeepFashion2Dataset(ann, img_dir)
    flipped = [not np.array_equal(g[0], plain[i][0]) for i, g in enumerate(got)]
    assert 0 < sum(flipped) < len(flipped)  # both branches ran


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shards", [1, 3])
def test_pair_sampler_batches_equal(fixture, drop_last, shards):
    img_dir, _, jax_ann, ann = fixture
    mine, theirs = df2.DeepFashion2Dataset(ann, img_dir), \
        jax_df2.DeepFashion2Dataset(jax_ann, img_dir)
    for shard in range(shards):
        kw = dict(batch_size=4, seed=7, num_shards=shards, shard=shard, drop_last=drop_last)
        a, b = df2.DF2PairBatchSampler(mine, **kw), jax_df2.DF2PairBatchSampler(theirs, **kw)
        assert len(a) == len(b)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got, want = list(a), list(b)
            assert got == want and got, (shard, epoch)
        unshuffled = df2.DF2PairBatchSampler(mine, shuffle=False, **kw)
        assert list(unshuffled) == list(jax_df2.DF2PairBatchSampler(theirs, shuffle=False, **kw))


@pytest.mark.parametrize("filter_onestreet", [True, False])
def test_multidf2_product_batches_equal(fixture, filter_onestreet):
    img_dir, _, jax_ann, ann = fixture

    def datasets(noise):
        return (multidf2.MultiDeepFashion2Dataset(ann, img_dir, noise=noise,
                                                  filter_onestreet=filter_onestreet,
                                                  rng=random.Random(5)),
                jax_multidf2.MultiDeepFashion2Dataset(jax_ann, img_dir, noise=noise,
                                                      filter_onestreet=filter_onestreet,
                                                      rng=random.Random(5)))

    mine, theirs = datasets(False)
    assert mine.product_keys == theirs.product_keys
    assert len(mine) == (2 if filter_onestreet else 3)
    cases = [dict(shuffle=False), dict(seed=3, epoch=1),
             dict(seed=3, epoch=2, num_shards=2, shard=1),
             dict(seed=3, epoch=1, limit=2, drop_last=True)]
    for noise in (False, True):
        for kw in cases:
            mine, theirs = datasets(noise)
            got = list(multidf2.product_batches(mine, 1, 3, **kw))
            want = list(jax_multidf2.product_batches(theirs, 1, 3, **kw))
            assert got, kw
            assert_same(got, want, f"noise {noise} {kw}")
        # skip_batches consumes the sampler's and the dataset's draws and loads
        # nothing, so the batches that remain are the uninterrupted run's
        mine, theirs = datasets(noise)
        got = list(multidf2.product_batches(mine, 1, 3, seed=4, epoch=1, skip_batches=1))
        want = list(jax_multidf2.product_batches(theirs, 1, 3, seed=4, epoch=1,
                                                 skip_batches=1))
        assert_same(got, want, f"noise {noise} skip")
        full = list(multidf2.product_batches(datasets(noise)[0], 1, 3, seed=4, epoch=1))
        assert_same(got, full[1:], f"noise {noise} skip vs full")
