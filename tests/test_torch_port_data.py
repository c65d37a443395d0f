"""The port's host data layer against the JAX package, bit for bit.

``ops/rle`` (the numpy path), ``data/synthetic`` (its numpy saturating add
in place of ``cv2.add``), ``data/movingfashion`` (the reader and the
``product_batches`` sampler, whose replay under ``skip_batches`` guards the
phase-2 resume) and the host ingest (``models/transform.host_batch_images``
against the JAX ``batch_images``, both cv2) on the same seeded inputs.
Fixtures are small files written by the JAX package's synthetic maker.
"""

import json
import random

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.data import movingfashion as jax_mf
from seam_match_rcnn_tpu.data import synthetic as jax_synthetic
from seam_match_rcnn_tpu.models.transform import batch_images as jax_batch_images
from seam_match_rcnn_tpu.ops import rle as jax_rle

from seam_match_rcnn_tpu_torch.data import movingfashion, synthetic
from seam_match_rcnn_tpu_torch.models.transform import host_batch_images
from seam_match_rcnn_tpu_torch.ops import rle
from torch_port_canvas import Canvas96x128, JaxCanvas96x128


def _masks(rng):
    """Binary masks with the edge cases of the run rules: empty, full, a
    leading 1, a trailing 1, and random blobs."""
    h, w = 13, 17
    out = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    lead = np.zeros((h, w), np.uint8)
    lead[:3, :2] = 1
    trail = np.zeros((h, w), np.uint8)
    trail[-2:, -1] = 255  # non-binary values binarize first
    out += [lead, trail]
    out += [(rng.rand(h, w) > t).astype(np.uint8) for t in (0.3, 0.7, 0.95)]
    return out


def test_rle_matches_jax():
    rng = np.random.RandomState(0)
    masks = _masks(rng)
    for m in masks:
        got, want = rle.encode(m), jax_rle.encode(m)
        assert got == want
        np.testing.assert_array_equal(rle.decode(got), jax_rle.decode(want))
        np.testing.assert_array_equal(rle.decode(got), (m != 0).astype(np.uint8))
        assert rle.area(got) == jax_rle.area(want)
        np.testing.assert_array_equal(rle.to_bbox(got), jax_rle.to_bbox(want))
    encoded = [rle.encode(m) for m in masks]
    np.testing.assert_array_equal(rle.mask_iou(encoded, encoded[::-1]),
                                  jax_rle.mask_iou(encoded, encoded[::-1]))
    with pytest.raises(ValueError):
        rle.decode({"size": [2, 2], "counts": [1, 2]})
    # compressed COCO strings: random well-formed LEB128 words
    for _ in range(20):
        n = rng.randint(1, 12)
        words = []
        for _ in range(n):
            k = rng.randint(1, 4)
            words += [chr(48 + 32 + rng.randint(0, 32)) for _ in range(k - 1)]
            words.append(chr(48 + rng.randint(0, 32)))
        s = "".join(words)
        assert rle._leb_decode(s) == jax_rle._leb_decode(s)
        assert rle._leb_decode(s.encode()) == jax_rle._leb_decode(s.encode())


def test_box_and_polygon_helpers_match_jax():
    rng = np.random.RandomState(1)
    a = np.concatenate([rng.uniform(0, 100, (6, 2)), rng.uniform(0, 60, (6, 2))], 1)
    np.testing.assert_array_equal(rle.box_iou_xywh(a, a[::-1]), jax_rle.box_iou_xywh(a, a[::-1]))
    polys = [[5.2, 4.1, 40.7, 6.0, 38.3, 30.9, 7.5, 28.2], [50, 10, 60, 12, 55, 25]]
    np.testing.assert_array_equal(rle.polygons_to_mask(polys, 40, 70),
                                  jax_rle.polygons_to_mask(polys, 40, 70))
    box = [4.0, 3.0, 42.0, 33.0]
    np.testing.assert_array_equal(rle.polygons_to_crop(polys, box, 28),
                                  jax_rle.polygons_to_crop(polys, box, 28))
    full = jax_rle.polygons_to_mask(polys, 40, 70)
    for b in (box, [-10.0, -5.0, 30.0, 20.0], [60.0, 35.0, 90.0, 60.0]):
        np.testing.assert_array_equal(rle.mask_to_crop(full, b, 28),
                                      jax_rle.mask_to_crop(full, b, 28))


def test_garment_image_is_bit_equal():
    rng = np.random.RandomState(2)
    for s in range(6):
        color = [int(c) for c in rng.randint(0, 256, 3)]
        color[s % 3] = 250  # + noise up to 19: the add saturates
        box = [int(v) for v in (rng.randint(0, 40), rng.randint(0, 30),
                                rng.randint(50, 100), rng.randint(40, 80))]
        got = synthetic._garment_image((80, 100), box, color, nprng=np.random.RandomState(s))
        want = jax_synthetic._garment_image((80, 100), box, color, nprng=np.random.RandomState(s))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mf_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("mf_jax")
    path = jax_synthetic.make_synthetic_movingfashion(str(root), n_products=5, n_frames=6,
                                                      frame_size=(48, 64))
    return str(root), path


@pytest.mark.parametrize("kind", ["movingfashion", "df2"])
def test_synthetic_fixtures_match_jax(kind, tmp_path):
    """The port's fixture makers write the JAX package's files byte for byte
    (the JSON, the jpgs; the mp4 through the same frames)."""
    name = f"make_synthetic_{kind}"
    kw = (dict(n_products=2, n_frames=4, frame_size=(48, 64)) if kind == "movingfashion"
          else dict(n_products=2, views_per_side=1, image_size=(100, 120)))
    getattr(synthetic, name)(str(tmp_path / "port"), **kw)
    getattr(jax_synthetic, name)(str(tmp_path / "jax"), **kw)
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert got == want and len(got) > 4
    for rel in want:
        if rel.suffix in (".json", ".jpg"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


@pytest.mark.parametrize("noise", [False, True])
def test_movingfashion_reader_matches_jax(mf_fixture, noise):
    root, path = mf_fixture
    got = movingfashion.MovingFashionDataset(path, root=root, noise=noise, rng=random.Random(5))
    want = jax_mf.MovingFashionDataset(path, root=root, noise=noise, rng=random.Random(5))
    assert got.product_ids == want.product_ids and len(got) == len(want) == 5
    for i in range(len(got)):
        _assert_items_equal(got.shop_image(i), want.shop_image(i))
        for frac in (0.0, 0.37, 0.99, 1.0):  # 1.0 seeks past the end: the dummy frame
            _assert_items_equal(got.video_frame(i, frac), want.video_frame(i, frac))
    assert got.rng.getstate() == want.rng.getstate()


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, epoch=2),
    dict(shuffle=False, uniform_sampling=True),
    dict(fixed_frames=[0.0, 0.5], fixed_video_i=0, drop_last=True),
    dict(num_shards=2, shard=1, seed=1),
    dict(skip_batches=1, seed=4, limit=4)], ids=["shuffle", "uniform", "fixed", "shards",
                                                "skip_batches"])
def test_product_batches_replay_as_jax(mf_fixture, kw):
    root, path = mf_fixture
    got_ds = movingfashion.MovingFashionDataset(path, root=root, noise=True, rng=random.Random(9))
    want_ds = jax_mf.MovingFashionDataset(path, root=root, noise=True, rng=random.Random(9))
    got = list(movingfashion.product_batches(got_ds, 2, 3, **kw))
    want = list(jax_mf.product_batches(want_ds, 2, 3, **kw))
    assert len(got) == len(want) >= 1
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            _assert_items_equal(g, w)
    assert got_ds.rng.getstate() == want_ds.rng.getstate()


def test_host_batch_images_is_bit_equal_to_jax():
    rng = np.random.RandomState(3)
    # landscape and portrait, one already at its canvas size (no resize)
    sizes = [(120, 160), (160, 120), (96, 128), (75, 200), (131, 97), (120, 160)]
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    want = jax_batch_images(images, JaxCanvas96x128(min_size=96, max_size=128))
    got = host_batch_images(images, Canvas96x128(min_size=96, max_size=128),
                            torch.device("cpu"))
    assert [g.indices for g in got] == [list(w.indices) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.sizes, w.sizes)
        np.testing.assert_array_equal(g.orig_sizes, w.orig_sizes)
        assert g.pixels.dtype == torch.float32 and g.pixels.is_contiguous()
        np.testing.assert_array_equal(g.pixels.permute(0, 2, 3, 1).numpy(), w.pixels)
