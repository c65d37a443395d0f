"""Checkpoints across the two packages.

* A port phase-1 file (the tiny config, one CPU training step, saved as
  ``cli.train_matchrcnn`` saves it) loads into the JAX package through its
  torch branch: ``load_torch_checkpoint`` and ``load_pretrained_detector``
  with the clone give the same detector, and the JAX video forward
  (inference and aggregator descriptors) then equals the port's, whose own
  ``load_pretrained_detector`` read the same file, within the tolerance of
  tests/test_torch_port_slice.py.
* A port phase-2 file (the whole video model) loads through the JAX
  ``load_torch_checkpoint(video=True)``, and the two packages give the same
  aggregated descriptors.
* ``tools/orbax_to_torch.py``: Orbax checkpoints the JAX package writes, of
  both CLI phases, converted to torch files, load into the port and give
  the JAX forward.
* ``import_imagenet_backbone`` matches the JAX one on a resnet50-shaped
  state dict built from the port's backbone body.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu import config as jc
from seam_match_rcnn_tpu.ckpt import io as jax_io
from seam_match_rcnn_tpu.ckpt import torch_convert as jax_tc
from seam_match_rcnn_tpu.models.matchrcnn import make_model as jax_model

from seam_match_rcnn_tpu_torch import config as pc
from seam_match_rcnn_tpu_torch.ckpt.io import CheckpointManager
from seam_match_rcnn_tpu_torch.ckpt.torch_convert import (import_imagenet_backbone,
                                                          load_pretrained_detector)
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.train.engine import bucket_batches
from seam_match_rcnn_tpu_torch.train.optim import sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer
from torch_port_canvas import Canvas96x128, JaxCanvas96x128

torch.set_num_threads(2)

TA = "roi_heads.temporal_aggregator."
TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_port_slice.py's forward tolerance


def _cfg(c, canvas):
    return c.ModelConfig(
        rpn=c.RPNConfig(pre_nms_top_n_train=80, post_nms_top_n_train=100,
                        pre_nms_top_n_test=60, post_nms_top_n_test=80, batch_size_per_image=32),
        roi_heads=c.RoIHeadsConfig(batch_size_per_image=64, detections_per_img=6),
        transform=canvas(min_size=96, max_size=128), compute_dtype="float32")


PCFG, JCFG = _cfg(pc, Canvas96x128), _cfg(jc, JaxCanvas96x128)


def _tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "orbax_to_torch.py"
    spec = importlib.util.spec_from_file_location("orbax_to_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_forward(model, images):
    with torch.no_grad():
        out = model.inference(torch.from_numpy(images).permute(0, 3, 1, 2),
                              torch.tensor([[96, 128]]))
        roi = out["roi_features"]
        out["aggr_features"] = model.aggregator_descriptors(
            roi.reshape((-1,) + roi.shape[2:])).reshape(1, -1, 256)
    return {k: v.numpy() for k, v in out.items()}


def _check_forward(got, want):
    v = want["valid"][0]
    np.testing.assert_array_equal(got["valid"][0], v)
    assert v.sum() >= 2
    for k in ("boxes", "scores", "match_features", "aggr_features"):
        np.testing.assert_allclose(got[k][0][v], want[k][0][v], **TOL, err_msg=k)


@pytest.fixture(scope="module")
def phase1(tmp_path_factory):
    """A port phase-1 file after one CPU step, the JAX video variables its
    torch branch reads from it, and the JAX video forward on one image."""
    root = tmp_path_factory.mktemp("cross")
    model = init_model(PCFG, device="cpu")
    rng = np.random.RandomState(3)
    images = [rng.rand(90, 120, 3).astype(np.float32) for _ in range(2)]
    targets = [{"boxes": np.asarray([[10.0, 12.0, 70.0, 80.0]], np.float32),
                "labels": np.asarray([3]), "pair_ids": np.asarray([1]),
                "styles": np.asarray([1]), "sources": np.asarray([i]),
                "mask_crops": np.ones((1, 56, 56), np.uint8)} for i in range(2)]
    # a small step: from random weights a larger one trains the classifier
    # to the background at once, and no box would pass the score threshold
    opt = sgd(model, lambda step: 1e-5, 0.9)
    Phase1Trainer(model, opt).step(bucket_batches(model, images, targets, 4, "cpu"),
                                   torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(root / "matchrcnn"), save_epochs=1)
    mgr.maybe_save(0, {"model_state_dict": model.state_dict(), **opt.state_dict(), "epoch": 0},
                   final=True)
    path = str(root / "matchrcnn" / "final.pt")

    # a torch file's warm start needs no base variables: the video model's
    # extras come from the JAX converter
    jmodel = jax_model(JCFG, video=True)
    plain = jax_tc.load_torch_checkpoint(path)
    variables = jax_tc.load_pretrained_detector(path, {}, clone_match_to_aggregator=True)
    for col in ("params", "batch_stats"):  # the torch branch's two readings agree
        for k, sub in plain[col].items():
            jax.tree.map(np.testing.assert_array_equal, sub, variables[col][k])
    image = rng.rand(1, 96, 128, 3).astype(np.float32)

    def fwd(m, im, sz):
        out = m.inference(im, sz)
        roi = out["roi_features"].reshape(-1, 14, 14, 256)
        out["aggr_features"] = m.aggregator_descriptors(roi).reshape(1, -1, 256)
        return out

    run = jax.jit(lambda v, im, sz: jmodel.apply(v, im, sz, method=fwd))
    want = jax.tree.map(np.asarray, run(variables, jnp.asarray(image), jnp.asarray([[96, 128]])))
    return {"root": root, "path": path, "model": model, "jmodel": jmodel,
            "variables": variables, "image": image, "want": want}


def test_port_phase1_file_loads_into_jax(phase1):
    port = load_pretrained_detector(phase1["path"], init_model(PCFG, video=True, device="cpu"))
    sd, trained = port.state_dict(), phase1["model"].state_dict()
    assert all(torch.equal(sd[k], v) for k, v in trained.items())  # the file's weights
    _check_forward(_port_forward(port, phase1["image"]), phase1["want"])


def test_port_phase2_file_aggregates_as_jax(phase1, tmp_path):
    port = load_pretrained_detector(phase1["path"], init_model(PCFG, video=True, device="cpu"))
    ta = port.roi_heads["temporal_aggregator"]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # a trained aggregator: W_z non-zero, the trunk moved
        for p in ta.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    mgr = CheckpointManager(str(tmp_path / "seam_mf"), save_epochs=1)
    mgr.maybe_save(3, {"model_state_dict": port.state_dict(), "epoch": 3})
    variables = jax_tc.load_torch_checkpoint(str(tmp_path / "seam_mf" / "epoch003.pt"),
                                             video=True)
    roi = np.random.RandomState(6).randn(8, 256, 14, 14).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    with torch.no_grad():
        desc = port.aggregator_descriptors(torch.from_numpy(roi))
        got = port.aggregate_sequences(desc.reshape(2, 4, 256), torch.from_numpy(mask)).numpy()
    jdesc = phase1["jmodel"].apply(variables, jnp.asarray(roi.transpose(0, 2, 3, 1)),
                                   method="aggregator_descriptors")
    want = phase1["jmodel"].apply(variables, jdesc.reshape(2, 4, 256), jnp.asarray(mask),
                                  method="aggregate_sequences")
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), **TOL)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("phase", ["phase1", "phase2"])
def test_orbax_to_torch_tool(phase1, tmp_path, phase):
    """The JAX CLIs' Orbax payloads, converted, load into the port and give
    the JAX forward.  A phase-1 tree has no aggregator: the port's warm start
    gives it the JAX converter's fresh NLB and attention and the clone, as
    the JAX variables got."""
    variables = jax.tree.map(np.asarray, phase1["variables"])
    if phase == "phase1":
        params = {k: v for k, v in variables["params"].items() if k != "temporal_aggregator"}
        stats = {k: v for k, v in variables["batch_stats"].items()
                 if k != "temporal_aggregator"}
        payload = {"state": {"params": params, "batch_stats": stats, "step": np.int32(4)},
                   "epoch": 1}
    else:
        payload = {"variables": variables, "epoch": 2}
    jax_io.save_checkpoint(str(tmp_path / "orbax"), payload)
    out = _tool().main(["--orbax", str(tmp_path / "orbax"), "--out", str(tmp_path / "p.pt")])
    saved = torch.load(out, map_location="cpu", weights_only=True)
    assert saved["epoch"] == payload["epoch"] and set(saved) == {"model_state_dict", "epoch"}
    assert any(k.startswith(TA) for k in saved["model_state_dict"]) == (phase == "phase2")
    port = load_pretrained_detector(out, init_model(PCFG, video=True, device="cpu"))
    _check_forward(_port_forward(port, phase1["image"]), phase1["want"])


def test_import_imagenet_backbone_matches_jax(phase1):
    port = init_model(PCFG, video=True, device="cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    body = "backbone.body."
    sd = {}
    for k, v in before.items():
        if k.startswith(body):
            noise = torch.rand(v.shape, generator=gen) * 0.1
            sd[k[len(body):]] = v + noise  # running_var stays positive
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 2048), torch.randn(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    import_imagenet_backbone(port, sd)
    after = port.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], sd[k[len(body):]] if k.startswith(body) else v), k
    want = jax_tc.import_imagenet_backbone(phase1["variables"], sd)["params"]["backbone"]["body"]
    got = jax_tc.convert_state_dict(after, video=True)["params"]["backbone"]["body"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0),
                 got, want)
    with pytest.raises(ValueError, match="resnet50 body"):
        import_imagenet_backbone(port, {"conv1.weight": sd["conv1.weight"]})
