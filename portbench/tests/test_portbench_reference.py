"""The reference agrees with the port's plain path at a small size: the same
weights through ``ModelConfig()``'s plain backends in float32 on the CPU."""

import dataclasses

import numpy as np
import torch

from portbench import generate
from portbench import model as M
from portbench.entries import train as train_entry
from portbench.reference import transform as rt

from . import tiny


def _plain(cfg: dict) -> dict:
    m = dict(cfg["model"], compute_dtype="float32", stem_backend="xla")
    m["roi_heads"] = dict(m["roi_heads"], roi_align_backend="xla")
    m["match"] = dict(m["match"], nlb_backend="xla")
    return dict(cfg, model=m)


def test_inference_matches_the_port():
    cfg = _plain(tiny.config("seam_serving"))
    port = M.port_model(cfg, 5, "cpu", tiny.transform())
    ref = M.reference_model(cfg, 5, "cpu", transform=tiny.transform())
    img = generate.products(tiny.mix("index_mf"), 9, "cpu")[0][1]
    canvas, (nh, nw) = rt.ingest(img, tiny.transform(), "cpu")
    sizes = torch.tensor([[nh, nw]])
    out = port.inference(canvas, sizes)
    feats, det = ref.detect(canvas, sizes)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_allclose(out[k].numpy(), getattr(det, k).numpy(), rtol=1e-5, atol=1e-5)
    roi = ref.roi_features(feats, det.boxes)
    np.testing.assert_allclose(out["match_features"][0].numpy(),
                               ref.match_descriptors(roi).numpy(), rtol=1e-4, atol=1e-5)
    agg = port.aggregate_sequences(out["match_features"][:, :3], torch.ones(1, 3, dtype=bool))
    np.testing.assert_allclose(
        agg.numpy(), ref.aggregate_sequences(out["match_features"][:, :3],
                                             torch.ones(1, 3, dtype=bool)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_training_losses_match_the_port():
    from seam_match_rcnn_tpu_torch.train.engine import bucket_batches

    cfg = _plain(tiny.config("matchrcnn_train"))
    mix = tiny.mix("phase1_b8")
    e = train_entry.Entry(cfg, mix, 3, "cpu", tiny.transform())
    e.setup_inputs()
    port = M.port_model(cfg, 5, "cpu", tiny.transform())
    ref = M.reference_model(cfg, 5, "cpu", transform=tiny.transform())
    images, targets = e.pool[0]
    draws, groups = e._draws(0, images)
    got = port.training_losses(bucket_batches(port, images, targets, mix["g_max"], "cpu"),
                               draws=draws)
    buckets = []
    for idx in groups:
        items = [rt.ingest(images[i], tiny.transform(), "cpu") for i in idx]
        gts = []
        for i, (_, hw) in zip(idx, items):
            t = dict(targets[i], boxes=rt.to_canvas_boxes(targets[i]["boxes"], hw,
                                                          images[i].shape[:2]))
            gts.append(rt.pad_target(t, mix["g_max"]))
        buckets.append({"images": torch.cat([c for c, _ in items]),
                        "sizes": torch.tensor([hw for _, hw in items]),
                        "gt": {k: torch.as_tensor(np.stack([g[k] for g in gts]))
                               for k in gts[0]}})
    want = ref.training_losses(buckets, draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k].detach()), rtol=1e-4,
                                   atol=1e-6)
    assert dataclasses.is_dataclass(ref.cfg)
