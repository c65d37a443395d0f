"""Serving CLI: the video-to-shop retrieval service, on PyTorch.

Port of ``seam_match_rcnn_tpu/cli/serve.py``, flag for flag, plus
``--device`` (default ``cuda``; without a card, pass ``--device cpu``):

  # 1. index the shop catalogue once (descriptors persisted to .npz)
  python -m seam_match_rcnn_tpu_torch.cli.serve --ckpt_path model.pth \\
      --build_gallery data/MovingFashion/test.json --root data/MovingFashion \\
      --gallery_index gallery.npz

  # 2a. one-shot query: video file (or a directory of frames) -> top-k JSON
  python -m seam_match_rcnn_tpu_torch.cli.serve --ckpt_path model.pth \\
      --gallery_index gallery.npz --query video.mp4 --topk 5

  # 2b. long-running JSON API (GET /healthz, GET /v1/products,
  #     POST /v1/query {"video": path, "topk": k}, POST /v1/detect)
  python -m seam_match_rcnn_tpu_torch.cli.serve --ckpt_path model.pth \\
      --gallery_index gallery.npz --http 8080

  # dataset-free demo: a synthetic fixture, its gallery and one query
  python -m seam_match_rcnn_tpu_torch.cli.serve --synthetic [--device cpu]

Queries run the SEAM aggr-desc strategy (detector forward, match-head
self-similarity tracking, temporal aggregation, gallery scoring).  A gallery
index written by either package serves from either.  Decoding video and
image files needs cv2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import EvalConfig, ModelConfig, serving_model_config
from ..models.matchrcnn import init_model
from ..serving import (Gallery, RetrievalResult, SeamRetrieval, decode_video_frames,
                       load_image_frames)
from ._args import add_device_flag, check_device

_VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def build_argparser():
    p = argparse.ArgumentParser("PyTorch SEAM video-to-shop retrieval service")
    p.add_argument("--ckpt_path", type=str, default="",
                   help="torch checkpoint file (the reference's key names); empty = "
                        "random init (demo only)")
    p.add_argument("--gallery_index", type=str, default="gallery.npz",
                   help="persisted gallery descriptor index (.npz)")
    p.add_argument("--build_gallery", type=str, default=None,
                   help="MovingFashion-schema annots json: index every "
                        "product's shop image into --gallery_index")
    p.add_argument("--root", type=str, default="",
                   help="root for paths inside --build_gallery json")
    p.add_argument("--query", type=str, default=None,
                   help="video file, image file, or directory of frames")
    p.add_argument("--detect", type=str, default=None,
                   help="one-shot detection: image/video/frame-dir -> "
                        "per-frame boxes + full-image masks (COCO "
                        "column-major RLE at 0.5) as JSON (no gallery needed)")
    p.add_argument("--no_masks", action="store_true",
                   help="--detect / /v1/detect without mask heads (boxes "
                        "and labels only; faster)")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--n_frames", type=int, default=10,
                   help="frames decoded per query video (uniform fractions)")
    p.add_argument("--score_threshold", type=float, default=0.0)
    p.add_argument("--tracking_threshold", type=float, default=0.3)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the JSON API on 127.0.0.1:PORT")
    p.add_argument("--http_host", type=str, default="127.0.0.1")
    p.add_argument("--media_root", type=str, default=None,
                   help="restrict HTTP query paths to this directory "
                        "(request paths are resolved relative to it; "
                        "escapes are rejected).  Strongly recommended with "
                        "a non-loopback --http_host: without it any "
                        "client can point the server at arbitrary local files")
    p.add_argument("--device_ingest", action="store_true",
                   help="raw-frame upload + resize on the device "
                        "(eval/runner ingest='device'; default: cv2 on the host)")
    p.add_argument("--exact_roi_align", action="store_true",
                   help="the plain PyTorch versions of every kernel (ModelConfig()) "
                        "instead of the serving profile's CUDA kernels")
    p.add_argument("--synthetic", action="store_true",
                   help="dataset-free demo: synthesize a MovingFashion "
                        "fixture, build its gallery, and answer one video "
                        "query end-to-end")
    add_device_flag(p)
    return p


def load_query_frames(path: str, n_frames: int) -> List[np.ndarray]:
    """video file -> uniform-fraction decode; directory -> sorted image
    files; single image -> one frame."""
    if os.path.isdir(path):
        files = sorted(
            f for f in glob.glob(os.path.join(path, "*"))
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if not files:
            raise ValueError(f"no image frames in directory: {path}")
        return load_image_frames(files[:n_frames])
    if path.lower().endswith(_VIDEO_EXTS):
        return decode_video_frames(path, n_frames)
    return load_image_frames([path])


def result_json(result: RetrievalResult) -> dict:
    return {
        "keys": list(result.keys),
        "scores": [float(s) for s in result.scores],
        "track_length": int(result.track_length),
    }


def detections_json(outs, score_threshold: float = 0.0) -> dict:
    """Runner outputs -> JSON-safe detections.  Full-image masks ship as
    COCO column-major uncompressed RLE of (prob > 0.5), decodable by
    ``ops.rle.decode`` (or pycocotools)."""
    from ..ops import rle as rle_mod

    frames = []
    for o in outs:
        keep = np.nonzero(o["valid"] & (o["scores"] >= score_threshold))[0]
        fr = {
            "boxes": [[float(v) for v in o["boxes"][i]] for i in keep],
            "scores": [float(o["scores"][i]) for i in keep],
            "labels": [int(o["labels"][i]) for i in keep],
        }
        if "masks" in o:
            fr["masks_rle"] = [
                {"size": r["size"],
                 "counts": [int(c) for c in r["counts"]]}
                for r in (rle_mod.encode(np.asarray(o["masks"][i]) > 0.5)
                          for i in keep)
            ]
            fr["mask_threshold"] = 0.5
        frames.append(fr)
    return {"frames": frames}


def build_gallery_from_json(retr: SeamRetrieval, annots: str, root: str) -> Gallery:
    from ..data.movingfashion import MovingFashionDataset

    ds = MovingFashionDataset(annots, root=root, noise=False)
    images = [ds.shop_image(i)["image"] for i in range(len(ds))]
    return retr.build_gallery(images, keys=list(ds.product_ids))


def make_http_server(retr: SeamRetrieval, gallery: Gallery, host: str,
                     port: int, n_frames_default: int = 10,
                     media_root: str = None, with_masks: bool = True):
    """JSON API over http.server (single-threaded on purpose: queries
    serialize on the one device anyway).  Returns the server; the caller
    runs serve_forever().

    ``media_root``: when set, request paths are resolved relative to it and
    must stay inside it (symlink-safe realpath check); otherwise any client
    that can reach the socket can probe local files through the error
    strings."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "gallery_size": len(gallery.keys),
                    "backend": "gpu" if torch.device(retr.device).type == "cuda" else "cpu",
                })
            elif self.path == "/v1/products":
                self._reply(200, {"keys": list(gallery.keys)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/v1/query", "/v1/detect"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                path = (req.get("video") or req.get("frames_dir")
                        or req.get("image"))
                if not path:
                    raise ValueError(
                        "body needs 'video', 'frames_dir' or 'image'")
                if media_root is not None:
                    root = os.path.realpath(media_root)
                    rp = os.path.realpath(
                        os.path.join(root, path.lstrip("/")))
                    if rp != root and not rp.startswith(root + os.sep):
                        raise ValueError(
                            "path escapes --media_root")
                    path = rp
                frames = load_query_frames(
                    path, int(req.get("n_frames", n_frames_default)))
                if self.path == "/v1/detect":
                    outs = retr.detect(frames, with_masks=with_masks)
                    self._reply(200, detections_json(
                        outs, float(req.get("score_threshold", 0.0))))
                else:
                    result = retr.retrieve(frames, gallery,
                                           k=int(req.get("topk", 5)))
                    self._reply(200, result_json(result))
            except Exception as e:  # served errors must not kill the process
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # quiet access log
            pass

    return HTTPServer((host, port), Handler)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    check_device(args.device)
    if args.synthetic:
        import tempfile

        from ..data.synthetic import make_synthetic_movingfashion

        root = tempfile.mkdtemp(prefix="seam_serve_demo_")
        annots = make_synthetic_movingfashion(root, n_products=3)
        args.build_gallery, args.root = annots, root
        args.gallery_index = os.path.join(root, "gallery.npz")
        with open(annots) as f:
            data = json.load(f)
        # query the first product's first video
        entry = data[sorted(data)[0]]
        args.query = os.path.join(root, entry["video_paths"][0])
        args.n_frames = 4

    cfg = ModelConfig() if args.exact_roi_align else serving_model_config()
    ecfg = EvalConfig(score_threshold=args.score_threshold,
                      tracking_threshold=args.tracking_threshold)
    ingest = "device" if args.device_ingest else "host"
    if args.ckpt_path:
        # a directory (the JAX package's Orbax checkpoint) raises
        # NotImplementedError there: tools/orbax_to_torch.py converts it
        retr = SeamRetrieval.from_checkpoint(
            args.ckpt_path, cfg=cfg, cfg_eval=ecfg, device=args.device, chunk=args.chunk,
            ingest=ingest)
    else:
        retr = SeamRetrieval(init_model(cfg, video=True, device=args.device), cfg=ecfg,
                             chunk=args.chunk, ingest=ingest)

    if args.detect:
        outs = retr.detect(
            load_query_frames(args.detect, args.n_frames),
            with_masks=not args.no_masks)
        payload = detections_json(outs, args.score_threshold)
        print(json.dumps(payload))
        return payload

    gallery: Optional[Gallery] = None
    if args.build_gallery:
        gallery = build_gallery_from_json(retr, args.build_gallery, args.root)
        path = gallery.save(args.gallery_index)
        print(f"gallery index: {len(gallery.keys)} products -> {path}")
    if gallery is None and (args.query or args.http is not None):
        gallery = Gallery.load(args.gallery_index)

    if args.query:
        result = retr.retrieve(
            load_query_frames(args.query, args.n_frames), gallery,
            k=args.topk)
        print(json.dumps(result_json(result)))
        return result

    if args.http is not None:
        server = make_http_server(retr, gallery, args.http_host, args.http,
                                  n_frames_default=args.n_frames,
                                  media_root=args.media_root,
                                  with_masks=not args.no_masks)
        print(f"serving on http://{args.http_host}:{args.http}  "
              f"(gallery: {len(gallery.keys)} products)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()


if __name__ == "__main__":
    main()
