"""MultiDeepFashion2 retrieval evaluation.

Port of ``seam_match_rcnn_tpu/eval/multidf2.py`` (the reference's
``evaluate_multiDF2.py``).  Differences from the MovingFashion evaluation:
box-to-product assignment by IoU against the product's GT box instead of
tracking, one query box per street image, "product max" takes the MEAN of
the ranks (the reference's behaviour, kept), and no regular/hard split.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Tuple

import numpy as np

from ..config import EvalConfig
from ..data.prefetch import prefetch
from ..ops.rle import box_iou_xywh
from .gallery import rank_of, score_matrix
from .movingfashion import _aggregate_batch, last_layers
from .runner import InferenceRunner

STRATEGIES = ("sfmr", "product_max", "avg_desc", "aggr_desc",
              "avg_dist", "max_dist", "max_score")


def _xywh(b):
    return np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1)


def _best_gt_box(target, key):
    style, pair_id = [int(x) for x in key.split("_")]
    m = (np.asarray(target["styles"]) == style) & (np.asarray(target["pair_ids"]) == pair_id)
    if not m.any():
        return None
    return np.asarray(target["boxes"])[m][:1]


def evaluate(
    model,
    products: Iterable[Dict],
    cfg: EvalConfig = EvalConfig(score_threshold=0.0, tracking_threshold=0.7),
    runner=None,
    out_dir: str = "logs_mdf2",
    save_artifacts: bool = True,
) -> Tuple[float, float, float]:
    """model: the video MatchRCNN; runner as in ``movingfashion.evaluate``.
    products yields dicts: images (shop first), targets (per image dict
    with boxes/styles/pair_ids), key ("<style>_<pair_id>"), has_video."""
    if runner is None:
        runner = InferenceRunner(model, chunk=cfg.infer_chunk, ingest=cfg.ingest)
    device = getattr(runner, "device", None) or next(model.parameters()).device
    # Overlap the NEXT product's host work (video decode / jpeg load in the
    # products generator) with the device inference of the current one —
    # the reference serializes DataLoader decode with the no_grad pass.
    products = prefetch(products)

    w, b, aggr_w, aggr_b = last_layers(model)

    shop_feats, shop_aggr, shop_keys = [], [], []
    street = {k: [] for k in ("feat", "aggr", "prod", "img", "score")}
    count_street = 0

    for prod in products:
        outs = runner(prod["images"])
        shop = outs[0]
        keep = np.nonzero((shop["scores"] >= cfg.score_threshold) & shop["valid"])[0]
        if keep.size == 0:
            continue
        gt_box = _best_gt_box(prod["targets"][0], prod["key"])
        if gt_box is None:
            continue
        iou = box_iou_xywh(_xywh(gt_box), _xywh(shop["boxes"][keep]))[0]
        best = keep[int(np.argmax(iou))]
        pidx = len(shop_feats)
        shop_feats.append(shop["match_features"][best])
        shop_aggr.append(shop["aggr_features"][best])
        shop_keys.append(prod["key"])

        if not prod.get("has_video", True):
            continue
        count_street += 1
        for i, (o, tgt) in enumerate(zip(outs[1:], prod["targets"][1:])):
            keep = np.nonzero((o["scores"] >= cfg.score_threshold) & o["valid"])[0]
            if keep.size == 0:
                continue
            # each street image's own GT box for the product (the reference
            # indexes targets[0]'s styles against street GT lists at
            # evaluate_multiDF2.py:88-92 — a latent bug, not behavior to copy)
            st_gt = _best_gt_box(tgt, prod["key"])
            if st_gt is None:
                continue
            iou = box_iou_xywh(_xywh(st_gt), _xywh(o["boxes"][keep]))[0]
            j = keep[int(np.argmax(iou))]
            street["feat"].append(o["match_features"][j])
            street["aggr"].append(o["aggr_features"][j])
            street["prod"].append(pidx)
            street["img"].append(i)
            street["score"].append(float(o["scores"][j]))

    if not shop_feats or not street["feat"]:
        print("evaluate: no usable shop/street detections")
        return 0.0, 0.0, 0.0
    shop_mat = np.stack(shop_feats)
    shop_aggr_mat = np.stack(shop_aggr)
    st_feat = np.stack(street["feat"])
    st_aggr = np.stack(street["aggr"])
    st_prod = np.asarray(street["prod"])
    st_score = np.asarray(street["score"])

    scores_qg = score_matrix(st_feat, shop_mat, w, b, device, dtype=cfg.gallery_dtype)
    ks = list(cfg.k_thresholds)
    hits = {s: np.zeros(len(ks), np.int64) for s in STRATEGIES}
    all_ranks = []
    aggr_jobs = []
    accs_per_product = {}

    # over ALL gallery indices, not range(count_street): gallery-only
    # (has_video=False) products occupy pidx slots too, so a video product
    # after one sits at pidx >= count_street — its queries must be scored
    # (same fix as eval/movingfashion.py; gallery-only products fall out at
    # the rows.size check)
    for pidx in range(len(shop_feats)):
        rows = np.nonzero(st_prod == pidx)[0]
        if rows.size == 0:
            continue
        key = shop_keys[pidx]
        ranks = [int(r) for r in rank_of(scores_qg[rows], pidx)]
        dists = [scores_qg[r] for r in rows]
        for rank in ranks:
            for j, k in enumerate(ks):
                if rank < k:
                    hits["sfmr"][j] += 1
        all_ranks.extend(ranks)
        accs_per_product[key] = {
            "sfmr": np.asarray([[int(r < k) for k in ks] for r in ranks]).sum(0)
            / cfg.frames_per_product
        }
        # reference uses the MEAN rank here (evaluate_multiDF2.py:201)
        mean_rank = int(np.mean(np.asarray(ranks)))
        for j, k in enumerate(ks):
            if mean_rank < k:
                hits["product_max"][j] += 1

        aggr_jobs.append((pidx, key, st_aggr[rows]))

        avg = st_feat[rows].mean(0, keepdims=True)
        avg_scores = score_matrix(avg, shop_mat, w, b, device, dtype=cfg.gallery_dtype)
        rank = int(rank_of(avg_scores, pidx)[0])
        for j, k in enumerate(ks):
            if rank < k:
                hits["avg_desc"][j] += 1

        dists = np.stack(dists)
        for strat, vec in (("avg_dist", dists.mean(0)), ("max_dist", dists.max(0))):
            rank = int(rank_of(vec[None], pidx)[0])
            for j, k in enumerate(ks):
                if rank < k:
                    hits[strat][j] += 1

        r = int(rows[int(np.argmax(st_score[rows]))])
        rank = int(rank_of(scores_qg[r][None], pidx)[0])
        for j, k in enumerate(ks):
            if rank < k:
                hits["max_score"][j] += 1

    if aggr_jobs:
        tmax = max(len(j[2]) for j in aggr_jobs)
        seqs = np.zeros((len(aggr_jobs), tmax, 256), np.float32)
        mask = np.zeros((len(aggr_jobs), tmax), bool)
        for i, (_, _, s) in enumerate(aggr_jobs):
            seqs[i, : len(s)] = s
            mask[i, : len(s)] = True
        agg = _aggregate_batch(model, seqs, mask, device)
        agg_scores = score_matrix(agg, shop_aggr_mat, aggr_w, aggr_b, device,
                                  dtype=cfg.gallery_dtype)
        for i, (pidx, key, _) in enumerate(aggr_jobs):
            rank = int(rank_of(agg_scores[i][None], pidx)[0])
            for j, k in enumerate(ks):
                if rank < k:
                    hits["aggr_desc"][j] += 1
            accs_per_product[key]["seamrcnn"] = np.asarray(
                [int(rank < k) for k in ks], np.float64
            )

    total_queries = max(count_street * cfg.frames_per_product, 1)
    denom = {s: max(count_street, 1) for s in STRATEGIES}
    denom["sfmr"] = total_queries
    labels = {
        "sfmr": "Retrieval Accuracy",
        "product_max": "Retrieval Accuracy Product Max",
        "avg_desc": "Retrieval Accuracy Product Avg Desc",
        "aggr_desc": "Retrieval Accuracy Product Aggr Desc",
        "avg_dist": "Retrieval Accuracy Product Avg Dist",
        "max_dist": "Retrieval Accuracy Product Max Dist",
        "max_score": "Retrieval Accuracy Product Max Score",
    }
    for s in STRATEGIES:
        for j, k in enumerate(ks):
            print("Top-%d %s: %1.4f" % (k, labels[s], hits[s][j] / denom[s]))
        print("*" * 50)
    all_ranks = np.asarray(all_ranks) if all_ranks else np.asarray([0])
    print(
        f"Rank median: {np.median(all_ranks)}; rank 1st quartile: "
        f"{np.percentile(all_ranks, 25)}; rank 3rd quartile: {np.percentile(all_ranks, 75)}"
    )

    if save_artifacts:
        import json

        os.makedirs(out_dir, exist_ok=True)
        perf = np.zeros((8, len(ks)))
        for row, s in enumerate(("sfmr", "product_max", "avg_desc", "aggr_desc")):
            perf[row] = [hits[s][j] / denom[s] * 100 for j in range(len(ks))]
        np.savetxt(os.path.join(out_dir, f"{time.time()}.csv"), perf,
                   fmt="%02.2f", delimiter="\t")
        # machine-readable metrics, same layout as the MF eval's
        # metrics.json (one split: MDF2 has no regular/hard partition)
        metrics = {"all": {
            s: {int(k): float(hits[s][j] / denom[s])
                for j, k in enumerate(ks)} for s in STRATEGIES
        }, "rank_median": float(np.median(all_ranks))}
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=float)

    return (
        float(hits["sfmr"][0] / total_queries),
        float(hits["avg_desc"][0] / denom["avg_desc"]),
        float(hits["aggr_desc"][0] / denom["aggr_desc"]),
    )
