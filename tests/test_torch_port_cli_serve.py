"""The port's serving CLI (``seam_match_rcnn_tpu_torch/cli/serve.py``).

The seven tests of tests/test_cli_serve.py against the port (gallery index
save/load, query ingestion from a video, a directory or an image, the JSON
API with its ``--media_root`` confinement, and the dataset-free
``--synthetic`` drive with the tiny model config patched in, on the CPU),
and two of the port's own: ``main`` raises where there is no card and no
``--device cpu``, and it serves a gallery index that the JAX package wrote.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.data.synthetic import make_synthetic_movingfashion
from seam_match_rcnn_tpu.serving import Gallery as JaxGallery

from seam_match_rcnn_tpu_torch.cli import serve
from seam_match_rcnn_tpu_torch.config import ModelConfig, RoIHeadsConfig, RPNConfig
from seam_match_rcnn_tpu_torch.ops import rle
from seam_match_rcnn_tpu_torch.serving import Gallery, RetrievalResult, decode_video_frames
from torch_port_canvas import Canvas96x128

torch.set_num_threads(2)


def _tiny_model_config():
    return ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
        roi_heads=RoIHeadsConfig(detections_per_img=6),
        transform=Canvas96x128(min_size=96, max_size=128),
        compute_dtype="float32",
    )


@pytest.fixture(scope="module")
def mf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cli")
    path = make_synthetic_movingfashion(str(root), n_products=3, n_frames=6)
    return str(root), path


def _first_video(mf_root, relative=False):
    root, annots = mf_root
    with open(annots) as f:
        data = json.load(f)
    rel = data[sorted(data)[0]]["video_paths"][0]
    return rel if relative else os.path.join(root, rel)


def test_gallery_save_load_roundtrip(tmp_path):
    g = Gallery(match_feats=np.random.RandomState(0).randn(4, 256).astype(np.float32),
                aggr_feats=np.random.RandomState(1).randn(4, 256).astype(np.float32),
                keys=["a", "b", "c", "d"])
    path = g.save(str(tmp_path / "idx"))       # extension appended
    assert path.endswith(".npz") and os.path.exists(path)
    for loaded in (Gallery.load(path), JaxGallery.load(path)):  # the JAX package reads it too
        np.testing.assert_array_equal(g.match_feats, loaded.match_feats)
        np.testing.assert_array_equal(g.aggr_feats, loaded.aggr_feats)
        assert loaded.keys == g.keys


def test_load_query_frames_video_dir_image(mf_root, tmp_path):
    import cv2

    frames = serve.load_query_frames(_first_video(mf_root), n_frames=4)
    assert len(frames) >= 1
    assert frames[0].ndim == 3 and frames[0].dtype == np.float32
    assert 0.0 <= frames[0].min() and frames[0].max() <= 1.0

    d = tmp_path / "frames"
    d.mkdir()
    for i, fr in enumerate(frames[:2]):
        cv2.imwrite(str(d / f"{i:03d}.jpg"), (fr[:, :, ::-1] * 255).astype(np.uint8))
    assert len(serve.load_query_frames(str(d), n_frames=8)) == 2
    assert len(serve.load_query_frames(str(d / "000.jpg"), n_frames=8)) == 1

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError):
        serve.load_query_frames(str(empty), n_frames=2)


def test_decode_video_frames_bad_path(tmp_path):
    with pytest.raises(ValueError):
        decode_video_frames(str(tmp_path / "missing.mp4"), 3)


class _FakeRetriever:
    """Stands in for SeamRetrieval in the HTTP tests: returns a fixed
    ranking, records the frames it was handed."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def retrieve(self, frames, gallery, k=5):
        self.calls.append(len(frames))
        k = min(k, len(gallery.keys))
        return RetrievalResult(indices=np.arange(k), scores=np.linspace(0.9, 0.1, k),
                               keys=gallery.keys[:k], track_length=len(frames))

    def detect(self, frames, with_masks=True):
        self.calls.append(len(frames))
        outs = []
        for fr in frames:
            h, w = fr.shape[:2]
            o = {"boxes": np.asarray([[2.0, 3.0, 20.0, 30.0], [0.0, 0.0, 1.0, 1.0]], np.float32),
                 "scores": np.asarray([0.9, 0.1], np.float32),
                 "labels": np.asarray([1, 2], np.int32),
                 "valid": np.asarray([True, False])}
            if with_masks:
                m = np.zeros((2, h, w), np.float32)
                m[0, 5:25, 4:15] = 0.8
                o["masks"] = m
            outs.append(o)
        return outs


class _Server:
    def __init__(self, retr, **kw):
        gallery = Gallery(np.zeros((3, 256), np.float32), np.zeros((3, 256), np.float32),
                          keys=["p0", "p1", "p2"])
        self.server = serve.make_http_server(retr, gallery, "127.0.0.1", 0, **kw)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()

    def get(self, path):
        return json.load(urllib.request.urlopen(self.base + path, timeout=10))

    def post(self, path, body):
        req = urllib.request.Request(self.base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(req, timeout=30))


def test_http_server_endpoints(mf_root):
    retr = _FakeRetriever()
    with _Server(retr) as srv:
        health = srv.get("/healthz")
        assert health == {"status": "ok", "gallery_size": 3, "backend": "cpu"}
        assert srv.get("/v1/products")["keys"] == ["p0", "p1", "p2"]
        out = srv.post("/v1/query", {"video": _first_video(mf_root), "topk": 2, "n_frames": 3})
        assert out["keys"] == ["p0", "p1"] and len(out["scores"]) == 2
        assert retr.calls and retr.calls[0] >= 1
        # served errors come back as 400 JSON, the process stays alive
        with pytest.raises(urllib.error.HTTPError) as ei:
            srv.post("/v1/query", {})
        assert ei.value.code == 400
        assert "error" in json.load(ei.value)
        assert srv.get("/healthz")["status"] == "ok"


def test_http_detect_endpoint(mf_root):
    """POST /v1/detect returns per-frame boxes and RLE full-image masks that
    round-trip through ops.rle.decode."""
    with _Server(_FakeRetriever()) as srv:
        out = srv.post("/v1/detect", {"video": _first_video(mf_root), "n_frames": 2,
                                      "score_threshold": 0.5})
    assert len(out["frames"]) >= 1
    fr = out["frames"][0]
    # the valid=False / below-threshold row was filtered
    assert fr["boxes"] == [[2.0, 3.0, 20.0, 30.0]]
    assert fr["labels"] == [1] and fr["mask_threshold"] == 0.5
    mask = rle.decode(fr["masks_rle"][0])
    assert mask.shape == tuple(fr["masks_rle"][0]["size"])
    assert mask[10, 10] == 1 and mask[0, 0] == 0
    assert int(mask.sum()) == 20 * 11


def test_serve_synthetic_end_to_end(monkeypatch, capsys):
    """``--synthetic --device cpu``: builds a fixture, indexes its gallery,
    answers one video query, with the tiny model config swapped in."""
    monkeypatch.setattr(serve, "serving_model_config", _tiny_model_config)
    result = serve.main(["--synthetic", "--topk", "2", "--device", "cpu"])
    assert isinstance(result, RetrievalResult)
    assert 1 <= len(result.keys) <= 2
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert payload["keys"] == list(result.keys)
    assert payload["track_length"] >= 1
    assert any("gallery index" in line for line in out)


def test_http_media_root_restriction(mf_root):
    """--media_root: request paths resolve relative to the root, and escapes
    (absolute or ..) are rejected with a 400."""
    root, _ = mf_root
    with _Server(_FakeRetriever(), media_root=root) as srv:
        out = srv.post("/v1/query", {"video": _first_video(mf_root, relative=True), "topk": 1,
                                     "n_frames": 2})
        assert out["keys"] == ["p0"]
        for bad in ({"video": "../../../etc/hostname"}, {"frames_dir": "../.."}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                srv.post("/v1/query", bad)
            assert ei.value.code == 400
            assert "escapes" in json.load(ei.value)["error"]


def test_main_needs_a_card_or_device_cpu(monkeypatch):
    """The CLI runs on the card; without one it raises rather than moving to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--synthetic"])


def test_main_serves_a_jax_written_gallery_index(monkeypatch, capsys, mf_root, tmp_path):
    """A gallery index written by the JAX package's ``Gallery.save`` (keys as
    an object array) serves a ``--query``, and ``--detect`` answers on the
    same video."""
    monkeypatch.setattr(serve, "serving_model_config", _tiny_model_config)
    rng = np.random.RandomState(4)
    path = JaxGallery(rng.randn(3, 256).astype(np.float32), rng.randn(3, 256).astype(np.float32),
                      ["prod_a", "prod_b", "prod_c"]).save(str(tmp_path / "jax_index"))
    result = serve.main(["--gallery_index", path, "--query", _first_video(mf_root),
                         "--n_frames", "3", "--topk", "3", "--device", "cpu"])
    assert sorted(result.keys) == ["prod_a", "prod_b", "prod_c"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["keys"] == result.keys
    payload = serve.main(["--detect", _first_video(mf_root), "--n_frames", "2",
                          "--device", "cpu"])
    assert len(payload["frames"]) == 2
    for fr in payload["frames"]:
        assert len(fr["masks_rle"]) == len(fr["boxes"]) == len(fr["scores"])
        assert all(r["size"] == [160, 200] for r in fr["masks_rle"])
