"""Shared synthetic-data training flow of the PyTorch port's profile gates,
the counterpart of tools/_synth_train.py.

Trains phase-1 Match R-CNN on a synthetic DeepFashion2 fixture at REAL
geometry (min side 800) and warm-starts the video model from it — the
reference ``load_saved_matchrcnn`` flow.  Used by
tools/validate_fast_profile_torch.py, tools/validate_int8_torch.py and
tools/validate_trunk_dtype_torch.py, so each gate trains ONE model and
varies only the serving knob under test on it.

Imports torch and the port, never jax or the JAX package; the numpy
instruments (``all_strategy_top1``, ``confusable_palette``,
``margin_analysis``, ``compare_probes``) are the JAX tool's, copied.
Everything runs on ``device``: the CUDA device unless the caller asks for
the CPU.
"""

import gc
import os
import tempfile

import numpy as np
import torch

from seam_match_rcnn_tpu_torch.ckpt.torch_convert import clone_match_to_aggregator
from seam_match_rcnn_tpu_torch.cli.train_movingfashion import _eval_products
from seam_match_rcnn_tpu_torch.cli.train_multidf2 import eval_products as mdf2_products
from seam_match_rcnn_tpu_torch.config import EvalConfig, ModelConfig
from seam_match_rcnn_tpu_torch.data import convert as conv
from seam_match_rcnn_tpu_torch.data.df2 import DF2PairBatchSampler, DeepFashion2Dataset
from seam_match_rcnn_tpu_torch.data.movingfashion import MovingFashionDataset
from seam_match_rcnn_tpu_torch.data.multidf2 import MultiDeepFashion2Dataset
from seam_match_rcnn_tpu_torch.data.synthetic import (make_synthetic_df2,
                                                      make_synthetic_movingfashion)
from seam_match_rcnn_tpu_torch.data.transforms import Compose, ToArray
from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix
from seam_match_rcnn_tpu_torch.eval.movingfashion import evaluate as eval_mf
from seam_match_rcnn_tpu_torch.eval.multidf2 import evaluate as eval_mdf2
from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.train.engine import train_one_epoch_matchrcnn
from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
from seam_match_rcnn_tpu_torch.train.steps import make_phase1_grad_apply


def synthetic_schedule(lr, epochs, steps):
    """The gates' learning rate by step: the JAX tool's
    ``multistep_warmup_schedule`` arguments."""
    return multistep_warmup_schedule(lr, (max(epochs - 2, 1),), 0.1, steps,
                                     min(60, steps * (epochs - 1)), 1e-2)


def train_synthetic_phase1(products, epochs, batch, lr, palette_colors=None,
                           device="cuda"):
    """Train on a fresh synthetic DF2 fixture; returns (trained, palette,
    root_dir), ``trained`` the phase-1 state dict on the CPU (the model is
    released from the card).  palette_colors: reuse an existing palette (the
    synthetic family's retrieval signal is color identity — eval products
    must share the train palette)."""
    root = tempfile.mkdtemp(prefix="synthval_")
    palette = palette_colors or [
        list(map(int, c))
        for c in np.random.RandomState(42).randint(64, 255, (products, 3))
    ]
    img_dir, ann_dir = make_synthetic_df2(
        os.path.join(root, "df2"), n_products=products, views_per_side=2,
        image_size=(160, 200), colors=palette)
    ann = os.path.join(root, "df2", "annots.json")
    conv.convert(img_dir, ann_dir, ann)

    # f32 compute: from-scratch training in bf16 at this scale NaNs once
    # warmup ends (the JAX tool's round-2 notes)
    cfg = ModelConfig(compute_dtype="float32")
    model = init_model(cfg, video=False, device=device)
    ds = DeepFashion2Dataset(ann, img_dir, transforms=Compose([ToArray()]))
    sampler = DF2PairBatchSampler(ds, batch, seed=0)
    steps = max(len(sampler), 1)
    # From-scratch full-geometry Mask R-CNN without an ImageNet backbone
    # diverges through the mask branch (the reference always warm-starts);
    # the tools only need a working detector, so clip gradients — a tool
    # choice, not a training-recipe parity claim.
    optimizer = sgd(model, synthetic_schedule(lr, epochs, steps), momentum=0.9,
                    clip_grad_norm=5.0)
    triple = make_phase1_grad_apply(model, optimizer)
    generator = torch.Generator(device=device).manual_seed(0)

    def batches(epoch):
        sampler.set_epoch(epoch)
        for idxs in sampler:
            items = [ds[i] for i in idxs]
            yield ([i[0] for i in items], [i[1] for i in items],
                   [i[2] for i in items])

    for ep in range(epochs):
        train_one_epoch_matchrcnn(model, triple, batches(ep), ep, generator, print_freq=4)
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, optimizer, triple
    release()
    return trained, palette, root


def release():
    """Return the card's cached blocks once the caller has dropped its
    references (``del``), so that one full model lives on it at a time."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def video_vars(vcfg, trained, device="cuda"):
    """The video model of ``vcfg`` warm-started from the trained phase-1
    state dict (reference load_saved_matchrcnn + clone_section semantics):
    every phase-1 tensor loaded, then the match predictor's trunk, ``last``
    and BatchNorm statistics copied into the temporal aggregator, whose NLB
    and attention keep the video model's own init."""
    model = init_model(vcfg, video=True, device=device)
    missing, unexpected = model.load_state_dict(trained, strict=False)
    stray = [k for k in missing if not k.startswith("roi_heads.temporal_aggregator.")]
    if unexpected or stray:
        raise RuntimeError(f"video_vars: the phase-1 state does not fit the video model: "
                           f"unexpected {unexpected[:5]}, missing {stray[:5]}")
    return clone_match_to_aggregator(model)


def all_strategy_top1(out_dir):
    """Read the eval harness's metrics.json: {strategy: top1} for every
    strategy it records (the 7 MF strategies or the MDF2 family)."""
    import json

    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    table = metrics["all"] if "all" in metrics else metrics
    out = {}
    for strat, per_k in table.items():
        if isinstance(per_k, dict):
            ks = sorted(int(k) for k in per_k)
            out[strat] = float(per_k[str(ks[0])])
    return out


def _runner(vmodel, chunk):
    # the host ingest (cv2): the JAX runner's default, and the eval
    # harnesses' (EvalConfig().ingest), so the probes see their pixels
    return InferenceRunner(vmodel, chunk=chunk, ingest="host", with_match=True,
                           with_aggr_features=False)


def descriptor_probe(vmodel, images):
    """Backend-drift probe at sub-quantum resolution (the top-1 gates
    resolve only ±1-2 product flips, so backends whose drift is far below
    the decision boundaries still show nonzero top-1 deltas from rounding
    noise).  Runs the serving forward on a FIXED probe image list and
    returns the per-detection match descriptors + scores as flat arrays;
    compare_probes() turns two backends' outputs into drift stats.

    images: list of HWC float arrays (identical across backends).
    """
    results = _runner(vmodel, 4)(images)
    desc = np.concatenate([r["match_features"] for r in results], 0)
    scores = np.concatenate([r["scores"] for r in results], 0)
    valid = np.concatenate([r["valid"] for r in results], 0).astype(bool)
    return {"desc": desc[valid], "scores": scores[valid]}


def confusable_palette(products, seed=42, delta=40):
    """Near-pair palette: products come in pairs whose colors differ by
    ``delta`` per channel — a harder confusable-garment mix.
    Distinguishing siblings forces small retrieval margins, so backend
    rounding that damages ranks becomes visible instead of hiding inside
    saturated top-1 tables.

    delta calibration (the JAX tool's): 18 (below the fixture's 0-20
    pixel noise) collapses the synthetic-trained model to top-1 == 0 on
    every strategy at 64 products — an instrument with no signal; 40 keeps
    sibling pairs the hardest discrimination while staying learnable."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = rng.randint(64, 255 - delta, ((products + 1) // 2, 3))
    sib = np.clip(base + rng.choice([-delta, delta], base.shape), 0, 255)
    palette = np.empty((base.shape[0] * 2, 3), np.int64)
    palette[0::2] = base
    palette[1::2] = sib
    return [list(map(int, c)) for c in palette[:products]]


def rank_margin_probe(vmodel, products):
    """Sub-quantum RANK instrument (descriptor drift alone measures
    rounding, not rank damage).  Runs the serving forward over the full
    product fixture, builds the street->shop avg-descriptor gallery score
    matrix, and returns per-product retrieval ranks AND the
    top1-vs-runner-up score margins.  Comparing two backends' outputs
    through ``margin_analysis`` separates rounding flips (margin below the
    control backends' own score drift) from real rank damage (flips at
    margins the drift cannot explain).  Scoring chain mirrored: the
    reference's evaluate_movingfashion.py:94-121 (match descriptors ->
    pairwise logits -> argsort); the scorer is the match predictor's
    ``last`` layer, as eval/movingfashion.last_layers reads it."""
    runner = _runner(vmodel, 8)
    last = vmodel.roi_heads["match_predictor"].last
    w = last.weight.detach()
    b = last.bias.detach()
    shop, street = [], []
    for prod in products:
        outs = runner(prod["images"])
        s = outs[0]
        keep = np.nonzero(s["valid"])[0]
        if keep.size == 0:
            shop.append(None)
            street.append(None)
            continue
        areas = (s["boxes"][keep, 2] - s["boxes"][keep, 0]) * (
            s["boxes"][keep, 3] - s["boxes"][keep, 1])
        shop.append(s["match_features"][keep[int(np.argmax(areas))]])
        descs = []
        for o in outs[1:]:
            k2 = np.nonzero(o["valid"])[0]
            if k2.size:
                descs.append(
                    o["match_features"][k2[int(np.argmax(o["scores"][k2]))]])
        street.append(np.mean(descs, 0) if descs else None)
    kept = [i for i in range(len(shop))
            if shop[i] is not None and street[i] is not None]
    if len(kept) < 2:
        return {"kept": kept}
    scores = np.asarray(score_matrix(
        np.stack([street[i] for i in kept]),
        np.stack([shop[i] for i in kept]), w, b))
    n = len(kept)
    ranks = np.empty((n,), np.int64)
    margins = np.empty((n,), np.float64)
    for r in range(n):
        row = scores[r]
        ranks[r] = int(np.sum(row > row[r]))  # rank of the true product
        others = np.delete(row, r)
        margins[r] = float(row[r] - np.max(others))
    return {"scores": scores, "ranks": ranks, "margins": margins,
            "kept": kept}


def margin_analysis(base, other):
    """Classify top-1 flips between two rank_margin_probe outputs.
    ``score_drift_max`` between a CONTROL pair of backends sets the noise
    bound; a flip whose |base margin| exceeds that bound is real rank
    damage, not rounding."""
    import numpy as np

    if base.get("kept") != other.get("kept") or "ranks" not in base:
        return {"detection_sets_diverged": True,
                "kept_base": len(base.get("kept", [])),
                "kept_other": len(other.get("kept", []))}
    flips = [i for i in range(len(base["ranks"]))
             if (base["ranks"][i] == 0) != (other["ranks"][i] == 0)]
    return {
        "score_drift_max": float(np.abs(base["scores"] -
                                        other["scores"]).max()),
        "top1_base": float((base["ranks"] == 0).mean()),
        "top1_other": float((other["ranks"] == 0).mean()),
        "n_products": int(len(base["ranks"])),
        "n_flips": len(flips),
        "flip_margins_base": [float(base["margins"][i]) for i in flips],
        "margin_min_abs": float(np.abs(base["margins"]).min()),
        "margin_median_abs": float(np.median(np.abs(base["margins"]))),
    }


def compare_probes(a, b):
    """Drift stats between two descriptor_probe() outputs (same probe set,
    same detection slots — valid-count mismatch means detection sets
    diverged, reported rather than crashed)."""
    import numpy as np

    if a["desc"].shape != b["desc"].shape:
        return {"detection_sets_diverged": True,
                "n_a": int(a["desc"].shape[0]), "n_b": int(b["desc"].shape[0])}
    dd = np.abs(a["desc"] - b["desc"])
    ds = np.abs(a["scores"] - b["scores"])
    # pairwise self-score matrix drift: how much the (street x shop)-style
    # score surface the eval ranks on moves between backends
    return {
        "desc_max_abs": float(dd.max()) if dd.size else 0.0,
        "desc_mean_abs": float(dd.mean()) if dd.size else 0.0,
        "score_max_abs": float(ds.max()) if ds.size else 0.0,
        "n_detections": int(a["desc"].shape[0]),
    }


def harness_arm(vcfg, trained, tag, root, mf, mdf2_fixture, frames, probe_images,
                device="cuda"):
    """One arm of the int8 and trunk-dtype gates: the video model of ``vcfg``
    warm-started from ``trained``, both eval harnesses (MovingFashion on
    ``mf``, MultiDF2 on the (annotations, image dir) ``mdf2_fixture``, logs
    under ``root``/logs_{mf,mdf2}_``tag``), the descriptor probe on
    ``probe_images`` and the rank-margin probe over ``mf``'s products.
    Returns ({"mf": top-1s, "mdf2": top-1s}, probe, rank probe); the model
    is released before it returns."""
    vmodel = video_vars(vcfg, trained, device)
    out_mf = os.path.join(root, f"logs_mf_{tag}")
    eval_mf(vmodel, _eval_products(mf, frames, None),
            EvalConfig(frames_per_product=frames, first_n_withvideo=None),
            out_dir=out_mf)
    mf_top1 = all_strategy_top1(out_mf)

    ann, img_dir = mdf2_fixture
    mds = MultiDeepFashion2Dataset(ann, img_dir, filter_onestreet=True)
    out_md = os.path.join(root, f"logs_mdf2_{tag}")
    eval_mdf2(vmodel, mdf2_products(mds, frames, None),
              EvalConfig(score_threshold=0.0, tracking_threshold=0.7,
                         frames_per_product=frames, first_n_withvideo=None),
              out_dir=out_md)
    md_top1 = all_strategy_top1(out_md)
    probe = descriptor_probe(vmodel, probe_images)
    # full-fixture rank+margin instrument: separates rounding flips from
    # real rank damage via top1/runner-up margins
    mprobe = rank_margin_probe(vmodel, _eval_products(mf, frames, None))
    del vmodel
    release()
    return {"mf": mf_top1, "mdf2": md_top1}, probe, mprobe


def probe_set(mf, frames):
    """The fixed probe set for the sub-quantum drift stats (top-1 flips
    bottom out at the ±1-product noise floor; descriptor/score drift
    separates backend rounding from real rank damage): the first two
    products' images."""
    probe_images = []
    for k, prod in enumerate(_eval_products(mf, frames, None)):
        probe_images.extend(prod["images"])
        if k >= 1:
            break
    return probe_images


def gate_summary(results, probes, mprobes, arms):
    """(deltas, probe drift, rank margins) of every arm against the first."""
    base = arms[0]
    drift = {bk: compare_probes(probes[bk], probes[base]) for bk in arms[1:]}
    margins = {bk: margin_analysis(mprobes[base], mprobes[bk]) for bk in arms[1:]}
    deltas = {
        bk: {ds: {s: results[bk][ds][s] - results[base][ds].get(s, 0.0)
                  for s in results[bk][ds]}
             for ds in results[bk]}
        for bk in arms[1:]
    }
    return deltas, drift, margins


def eval_fixtures(root, products, palette):
    """The int8 and trunk gates' eval fixtures under ``root``, on the
    training palette (color identity is the synthetic family's retrieval
    signal): the MovingFashion dataset (8 frames a product, read with
    noise) and the MultiDF2 fixture (annotations, image dir), which re-uses
    the DF2 generator for street/shop products (the eval only needs
    boxes/styles/pair_ids per image)."""
    mf_json = make_synthetic_movingfashion(
        os.path.join(root, "mf"), n_products=products, n_frames=8,
        colors=palette)
    mf = MovingFashionDataset(mf_json, root=os.path.join(root, "mf"),
                              noise=True)
    mroot = os.path.join(root, "mdf2")
    img_dir, ann_dir = make_synthetic_df2(
        mroot, n_products=products, views_per_side=2,
        image_size=(160, 200), colors=palette)
    ann = os.path.join(mroot, "annots.json")
    conv.convert(img_dir, ann_dir, ann)
    return mf, (ann, img_dir)
