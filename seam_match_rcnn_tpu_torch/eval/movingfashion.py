"""MovingFashion video-to-shop retrieval evaluation.

Port of ``seam_match_rcnn_tpu/eval/movingfashion.py`` (the reference's
``evaluate_movingfashion.py``):

  PHASE A  descriptor extraction: the runner's forward per product (1 shop +
           T frames) on the model's device; the shop keeps its largest box,
           every street box above the score threshold becomes a query, and
           only [D, 256] match and aggregator descriptors reach the host.
  PHASE B  gallery math: one [Q, G] match-probability matrix
           (``eval/gallery.score_matrix``: kernel K4 on the card, or the
           reference's numpy fp16 chain).
  PHASE C  per-product host loop: greedy tracking (oracle GT pick), then the
           seven strategies (single frame, product max, aggregated
           descriptor (kernel K3 through ``aggregate_sequences``), averaged
           descriptor, avg/max distance, max confidence), regular/hard
           splits, rank quartiles and the average track length.

Returns (top1_single, top1_avg_desc, top1_aggr_desc) and writes the
timestamped CSV, ``accs_per_product.npz`` and ``metrics.json`` in the JAX
package's formats.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..config import EvalConfig
from ..data.prefetch import prefetch
from .gallery import score_matrix
from .runner import InferenceRunner
from .tracking import build_tracklets, select_tracklet

STRATEGIES = (
    "sfmr", "product_max", "avg_desc", "aggr_desc",
    "avg_dist", "max_dist", "max_score",
)


class _Acc:
    """Top-k hit counters with regular/hard splits."""

    def __init__(self, ks):
        self.ks = list(ks)
        self.hits = {s: np.zeros(len(self.ks), np.int64) for s in STRATEGIES}
        self.hits_reg = {s: np.zeros(len(self.ks), np.int64) for s in STRATEGIES}
        self.hits_hard = {s: np.zeros(len(self.ks), np.int64) for s in STRATEGIES}

    def add(self, strategy, rank, source):
        for j, k in enumerate(self.ks):
            if rank < k:
                self.hits[strategy][j] += 1
                (self.hits_reg if source == 1 else self.hits_hard)[strategy][j] += 1


def _aggregate_batch(model, seqs: np.ndarray, mask: np.ndarray, device) -> np.ndarray:
    """Run the aggregator's descriptor-sequence mode (NLB + attention, kernel
    K3 on the card) over padded [P, T, 256] sequences: the reference's
    x3_1_seq path."""
    agg = model.aggregate_sequences(torch.as_tensor(seqs, device=device),
                                    torch.as_tensor(mask, device=device))
    return agg.cpu().numpy()


def last_layers(model):
    """(w, b, aggr_w, aggr_b) numpy: the match and aggregator scorers' last
    layers ([2, 256], [2]), which score descriptor pairs."""
    heads = model.roi_heads
    return tuple(t.detach().cpu().numpy() for t in (
        heads["match_predictor"].last.weight, heads["match_predictor"].last.bias,
        heads["temporal_aggregator"].last.weight, heads["temporal_aggregator"].last.bias))


def _json_ready(x):
    if isinstance(x, dict):
        return {k: _json_ready(v) for k, v in x.items()}
    return float(x) if isinstance(x, (np.floating, np.integer)) else x


def evaluate(
    model,
    products: Iterable[Dict],
    cfg: EvalConfig = EvalConfig(),
    runner=None,
    out_dir: str = "logs_mf",
    save_artifacts: bool = True,
) -> Tuple[float, float, float]:
    """model: the video MatchRCNN (its weights in its modules).  runner: a
    callable from a list of images to per-image output dicts (default: an
    ``InferenceRunner`` with ``cfg.infer_chunk`` and ``cfg.ingest``); scoring
    and aggregation run on the runner's device (or the model's).

    products yields per-product dicts:
      images:       [shop_img, frame_1, ..., frame_T] HWC float [0,1] arrays
      tracklet_gt:  [T, 4] GT tracklet box per frame ([-1]*4 if unannotated)
      source:       int (1 regular, else hard)
      key:          product identifier
      has_video:    bool — False replicates first_n_withvideo gallery-only
                    entries (the reference's evaluate_movingfashion.py:50-51)
    """
    if runner is None:
        runner = InferenceRunner(model, chunk=cfg.infer_chunk, ingest=cfg.ingest)
    device = getattr(runner, "device", None) or next(model.parameters()).device
    # Overlap the NEXT product's host work (video decode / jpeg load in the
    # products generator) with the device inference of the current one —
    # the reference serializes DataLoader decode with the no_grad pass.
    products = prefetch(products)

    shop_feats, shop_aggr, shop_sources, shop_keys = [], [], [], []
    street = {k: [] for k in ("feat", "aggr", "prod", "img", "score", "box")}
    tracklets_gt: List[np.ndarray] = []
    count_street = 0

    w, b, aggr_w, aggr_b = last_layers(model)

    for prod in products:
        outs = runner(prod["images"])
        shop = outs[0]
        keep = np.nonzero((shop["scores"] >= cfg.score_threshold) & shop["valid"])[0]
        if keep.size == 0:
            continue
        areas = (shop["boxes"][keep, 2] - shop["boxes"][keep, 0]) * (
            shop["boxes"][keep, 3] - shop["boxes"][keep, 1]
        )
        best = keep[int(np.argmax(areas))]
        pidx = len(shop_feats)
        shop_feats.append(shop["match_features"][best])
        shop_aggr.append(shop["aggr_features"][best])
        shop_sources.append(int(prod["source"]))
        shop_keys.append(prod["key"])

        if not prod.get("has_video", True):
            tracklets_gt.append(None)
            continue
        count_street += 1
        tracklets_gt.append(np.asarray(prod["tracklet_gt"], np.float32))
        for i, o in enumerate(outs[1:]):
            keep = np.nonzero((o["scores"] >= cfg.score_threshold) & o["valid"])[0]
            for j in keep:
                street["feat"].append(o["match_features"][j])
                street["aggr"].append(o["aggr_features"][j])
                street["prod"].append(pidx)
                street["img"].append(i)
                street["score"].append(float(o["scores"][j]))
                street["box"].append(o["boxes"][j])

    if not shop_feats or not street["feat"]:
        print("evaluate: no usable shop/street detections")
        return 0.0, 0.0, 0.0
    shop_mat = np.stack(shop_feats)
    shop_aggr_mat = np.stack(shop_aggr)
    shop_sources = np.asarray(shop_sources)
    st_feat = np.stack(street["feat"])
    st_aggr = np.stack(street["aggr"])
    st_prod = np.asarray(street["prod"])
    st_img = np.asarray(street["img"])
    st_score = np.asarray(street["score"])
    st_box = np.stack(street["box"])

    # PHASE B — one big score matrix on device.
    scores_qg = score_matrix(st_feat, shop_mat, w, b, device, dtype=cfg.gallery_dtype)

    acc = _Acc(cfg.k_thresholds)
    count_reg = count_hard = 0
    total_single_queries = count_street * cfg.frames_per_product
    all_ranks, track_lens = [], []
    accs_per_product = {}
    aggr_jobs = []  # (pidx, source, key, seq [T,256])

    # Over ALL gallery indices, not range(count_street): gallery-only
    # (has_video=False) products occupy pidx slots too, so a video product
    # can sit at pidx >= count_street when a gallery-only one precedes it —
    # its rows exist in st_prod and must be scored.  Gallery-only products
    # fall out at the rows.size check.
    for pidx in range(len(shop_feats)):
        rows = np.nonzero(st_prod == pidx)[0]
        if rows.size == 0:
            continue
        source = shop_sources[pidx]
        key = shop_keys[pidx]
        if source == 1:
            count_reg += 1
        else:
            count_hard += 1

        # TRACKING (oracle GT selection)
        self_sim = score_matrix(st_feat[rows], st_feat[rows], w, b, device,
                                dtype=cfg.gallery_dtype)
        tracks = build_tracklets(
            self_sim, st_score[rows], st_img[rows], cfg.tracking_threshold
        )
        tid = select_tracklet(
            tracks, st_box[rows], st_img[rows], tracklets_gt[pidx]
        )
        track = np.asarray(tracks[tid])
        track_lens.append(len(track))
        track_rows = rows[track]
        track_imgs = st_img[track_rows]

        # per-image best box = the tracked box of that frame
        ranks, best_rows, dists, dscores = [], [], [], []
        for img in np.unique(st_img[rows]):
            m = track_imgs == img
            if not m.any():
                continue
            r = int(track_rows[m][0])
            order = np.argsort(scores_qg[r])[::-1]
            rank = int(np.nonzero(order == pidx)[0][0])
            ranks.append(rank)
            best_rows.append(r)
            dists.append(scores_qg[r])
            dscores.append(st_score[r])
            acc.add("sfmr", rank, source)
        if not ranks:
            continue
        all_ranks.extend(ranks)
        # per-product per-query sfmr hit rate (evaluate_movingfashion.py:333)
        accs_per_product[key] = {
            "sfmr": np.asarray(
                [[int(r < k) for k in cfg.k_thresholds] for r in ranks]
            ).sum(0) / cfg.frames_per_product
        }

        acc.add("product_max", int(np.min(ranks)), source)
        best_rows = np.asarray(best_rows)

        # AGGR DESC — batched at the end
        aggr_jobs.append((pidx, source, key, st_aggr[best_rows]))

        # AVG DESC
        avg = st_feat[best_rows].mean(0, keepdims=True)
        avg_scores = score_matrix(avg, shop_mat, w, b, device, dtype=cfg.gallery_dtype)[0]
        rank = int(np.nonzero(np.argsort(avg_scores)[::-1] == pidx)[0][0])
        acc.add("avg_desc", rank, source)

        # AVG & MAX DIST
        dists = np.stack(dists)
        for strat, vec in (("avg_dist", dists.mean(0)), ("max_dist", dists.max(0))):
            rank = int(np.nonzero(np.argsort(vec)[::-1] == pidx)[0][0])
            acc.add(strat, rank, source)

        # MAX CONFIDENCE SCORE
        r = int(best_rows[int(np.argmax(np.asarray(dscores)))])
        order = np.argsort(scores_qg[r])[::-1]
        acc.add("max_score", int(np.nonzero(order == pidx)[0][0]), source)

    # AGGR DESC: one padded batch through the aggregator + one score matrix.
    if aggr_jobs:
        tmax = max(len(j[3]) for j in aggr_jobs)
        seqs = np.zeros((len(aggr_jobs), tmax, 256), np.float32)
        mask = np.zeros((len(aggr_jobs), tmax), bool)
        for i, (_, _, _, s) in enumerate(aggr_jobs):
            seqs[i, : len(s)] = s
            mask[i, : len(s)] = True
        agg = _aggregate_batch(model, seqs, mask, device)
        agg_scores = score_matrix(agg, shop_aggr_mat, aggr_w, aggr_b, device,
                                  dtype=cfg.gallery_dtype)
        for i, (pidx, source, key, _) in enumerate(aggr_jobs):
            rank = int(np.nonzero(np.argsort(agg_scores[i])[::-1] == pidx)[0][0])
            acc.add("aggr_desc", rank, source)
            accs_per_product[key]["seamrcnn"] = np.asarray(
                [int(rank < k) for k in cfg.k_thresholds], np.float64
            )

    # ---- report ---------------------------------------------------------
    ks = list(cfg.k_thresholds)
    denom = {
        "sfmr": max(total_single_queries, 1),
        **{s: max(count_street, 1) for s in STRATEGIES if s != "sfmr"},
    }
    denom_reg = {"sfmr": max(count_reg * cfg.frames_per_product, 1),
                 **{s: max(count_reg, 1) for s in STRATEGIES if s != "sfmr"}}
    denom_hard = {"sfmr": max(count_hard * cfg.frames_per_product, 1),
                  **{s: max(count_hard, 1) for s in STRATEGIES if s != "sfmr"}}

    labels = {
        "sfmr": "Retrieval Accuracy",
        "product_max": "Retrieval Accuracy Product Max",
        "avg_desc": "Retrieval Accuracy Product Avg Desc",
        "aggr_desc": "Retrieval Accuracy Product Aggr Desc",
        "avg_dist": "Retrieval Accuracy Product Avg Dist",
        "max_dist": "Retrieval Accuracy Product Max Dist",
        "max_score": "Retrieval Accuracy Product Max Score",
    }
    metrics = {}
    for split, hits, dn in (
        ("all", acc.hits, denom), ("regular", acc.hits_reg, denom_reg),
        ("hard", acc.hits_hard, denom_hard),
    ):
        metrics[split] = {
            s: {k: hits[s][j] / dn[s] for j, k in enumerate(ks)} for s in STRATEGIES
        }
    for s in STRATEGIES:
        for k in ks:
            print("Top-%d %s: %1.4f" % (k, labels[s], metrics["all"][s][k]))
        print("*" * 50)

    all_ranks = np.asarray(all_ranks) if all_ranks else np.asarray([0])
    print(
        f"Rank median: {np.median(all_ranks)}; rank 1st quartile: "
        f"{np.percentile(all_ranks, 25)}; rank 3rd quartile: {np.percentile(all_ranks, 75)}"
    )
    atl = float(np.mean(track_lens)) if track_lens else 0.0
    print(f"Average Track Length: {atl}")
    metrics["rank_median"] = float(np.median(all_ranks))
    metrics["avg_track_length"] = atl

    if save_artifacts:
        os.makedirs(out_dir, exist_ok=True)
        # 8 rows with only 0-3 filled replicates the REFERENCE's own CSV
        # quirk (evaluate_movingfashion.py:126 allocates 8, :435-438 fill
        # 4) — parity artifact, do not "fix"
        perf = np.zeros((8, len(ks)))
        for row, s in enumerate(("sfmr", "product_max", "avg_desc", "aggr_desc")):
            perf[row] = [metrics["all"][s][k] * 100 for k in ks]
        np.savetxt(os.path.join(out_dir, f"{time.time()}.csv"), perf,
                   fmt="%02.2f", delimiter="\t")
        np.savez(os.path.join(out_dir, "accs_per_product.npz"),
                 **{k: np.asarray([v.get("sfmr"), v.get("seamrcnn")], dtype=object)
                    for k, v in accs_per_product.items()})
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(_json_ready(metrics), f, indent=2, default=float)

    return (
        float(metrics["all"]["sfmr"][ks[0]]),
        float(metrics["all"]["avg_desc"][ks[0]]),
        float(metrics["all"]["aggr_desc"][ks[0]]),
    )
