"""The port's training and evaluation CLIs (``cli/train_matchrcnn``,
``train_movingfashion``, ``train_multidf2``, ``evaluate_movingfashion``,
``evaluate_multidf2`` and ``deepf_to_coco``) on the CPU.

* Every CLI's argparse defaults equal the JAX CLI's, as dicts, apart from
  the port's ``--device``.
* ``--synthetic --device cpu`` runs each end to end, writing and reading its
  torch-file checkpoints: phase 1 with its own reduced geometry on a 96x128
  canvas (and one product of one view a side, which keeps the epoch at 2
  steps), the others with the tiny model config patched in, as
  tests/test_torch_port_cli_serve.py does.
* A run stopped after a mid-epoch save finishes under ``--auto_resume``
  (phase 1 and MovingFashion), and the MultiDF2 run leaves the match
  predictor bit-equal.
* Each ``main`` raises where there is no card and no ``--device cpu``.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.cli import deepf_to_coco as jax_deepf_to_coco
from seam_match_rcnn_tpu.cli import evaluate_movingfashion as jax_eval_mf
from seam_match_rcnn_tpu.cli import evaluate_multidf2 as jax_eval_mdf2
from seam_match_rcnn_tpu.cli import train_matchrcnn as jax_train_p1
from seam_match_rcnn_tpu.cli import train_movingfashion as jax_train_mf
from seam_match_rcnn_tpu.cli import train_multidf2 as jax_train_mdf2

from seam_match_rcnn_tpu_torch.ckpt.io import CheckpointManager, restore_checkpoint
from seam_match_rcnn_tpu_torch.cli import (deepf_to_coco, evaluate_movingfashion,
                                           evaluate_multidf2, train_matchrcnn,
                                           train_movingfashion, train_multidf2)
from seam_match_rcnn_tpu_torch.config import (ModelConfig, RoIHeadsConfig, RPNConfig,
                                              TransformConfig)
from seam_match_rcnn_tpu_torch.data import synthetic
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from torch_port_canvas import Canvas96x128, small_canvas

torch.set_num_threads(2)

PAIRS = [(train_matchrcnn, jax_train_p1), (train_movingfashion, jax_train_mf),
         (train_multidf2, jax_train_mdf2), (evaluate_movingfashion, jax_eval_mf),
         (evaluate_multidf2, jax_eval_mdf2)]
MP = "roi_heads.match_predictor."


def _tiny_model_config():
    return ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
        roi_heads=RoIHeadsConfig(detections_per_img=6),
        transform=Canvas96x128(min_size=96, max_size=128),
        compute_dtype="float32",
    )


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run in ``tmp_path``: the CLIs' synthetic fixtures, logs and the
    in-loop evaluations' artifacts go there."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for mod in (train_movingfashion, train_multidf2, evaluate_movingfashion):
        monkeypatch.setattr(mod, "serving_model_config", _tiny_model_config)
    return tmp_path


class Stop(Exception):
    pass


def _stop_after_first_mid_save(monkeypatch):
    save_mid = CheckpointManager.save_mid

    def stop(self, payload):
        save_mid(self, payload)
        raise Stop(payload["step_in_epoch"])

    monkeypatch.setattr(CheckpointManager, "save_mid", stop)


@pytest.mark.parametrize("mine,theirs", PAIRS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_defaults_equal_the_jax_cli(mine, theirs):
    got = vars(mine.build_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == vars(theirs.build_argparser().parse_args([]))


def test_deepf_to_coco_parses_as_the_jax_cli(monkeypatch, capsys):
    """The JAX converter CLI builds its parser inside ``main``: both mains
    hand ``convert`` the same arguments, defaults included."""
    calls = []

    def convert(*args, **kw):
        calls.append((args, kw))
        return {"images": [], "annotations": []}

    monkeypatch.setattr(deepf_to_coco, "convert", convert)
    monkeypatch.setattr(jax_deepf_to_coco, "convert", convert)
    for argv in (["--image_dir", "i", "--annos_dir", "a", "--out", "o"],
                 ["--image_dir", "i", "--annos_dir", "a", "--out", "o", "--limit", "3"]):
        deepf_to_coco.main(argv)
        jax_deepf_to_coco.main(argv)
        assert calls[-1] == calls[-2] and calls[-1][0] == ("i", "a", "o")
    out = capsys.readouterr().out.splitlines()
    assert out == ["wrote 0 images, 0 annotations"] * 4


@pytest.mark.parametrize("cli", [p[0] for p in PAIRS], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_needs_a_card_or_device_cpu(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic"])


def test_train_matchrcnn_synthetic_stops_and_auto_resumes(in_tmp, monkeypatch, capsys):
    """Phase 1 with its reduced geometry on the 96x128 canvas, on one product
    of one street and one shop view (an epoch of 2 steps): a run stopped
    right after its mid save at step 0 resumes under ``--auto_resume`` from
    mid.pt, skips the trained batch and writes epoch000.pt and final.pt
    (the mid slot cleared)."""
    monkeypatch.setattr(train_matchrcnn, "TransformConfig", small_canvas(TransformConfig,
                                                                         (96, 128)))
    make = synthetic.make_synthetic_df2
    monkeypatch.setattr(synthetic, "make_synthetic_df2",
                        lambda root, **kw: make(root, **dict(kw, n_products=1, views_per_side=1)))
    ckpt = in_tmp / "ckpt"
    argv = ["--synthetic", "--device", "cpu", "--save_steps", "1", "--save_epochs", "1",
            "--save_dir", str(ckpt), "--log_dir", str(in_tmp / "runs")]
    with monkeypatch.context() as m:
        _stop_after_first_mid_save(m)
        with pytest.raises(Stop):
            train_matchrcnn.main(argv)
    tag = ckpt / "matchrcnn"
    assert sorted(os.listdir(tag)) == ["mid.pt"]
    mid = restore_checkpoint(str(tag / "mid.pt"))
    assert (mid["epoch"], mid["step_in_epoch"], mid["optimizer_count"]) == (0, 0, 1)
    assert mid["generator"].dtype == torch.uint8

    assert train_matchrcnn.main(argv + ["--auto_resume"]) is None
    out = capsys.readouterr().out
    assert f"auto-resume from {tag / 'mid.pt'}" in out
    assert "mid-epoch resume: epoch 0, skipping 1 batches" in out
    assert sorted(os.listdir(tag)) == ["epoch000.pt", "final.pt"]
    final = torch.load(str(tag / "final.pt"), map_location="cpu", weights_only=True)
    assert final["epoch"] == 0 and final["optimizer_count"] == 2
    assert set(final) == {"model_state_dict", "optimizer_state_dict", "optimizer_count", "epoch"}
    sd = final["model_state_dict"]
    assert all(v.device.type == "cpu" for v in sd.values())
    # the stem and layer1 stayed, the trainable layers moved
    init = init_model(dataclasses.replace(ModelConfig(), compute_dtype="float32"), device="cpu")
    ref = init.state_dict()
    assert torch.equal(sd["backbone.body.conv1.weight"], ref["backbone.body.conv1.weight"])
    assert torch.equal(sd["backbone.body.layer1.0.conv1.weight"],
                       ref["backbone.body.layer1.0.conv1.weight"])
    assert not torch.equal(sd["backbone.body.layer2.0.conv1.weight"],
                           ref["backbone.body.layer2.0.conv1.weight"])
    # an epoch file resumes at the next epoch: with --epochs 1 nothing is left to do
    os.remove(tag / "final.pt")
    train_matchrcnn.main(argv + ["--start_ckpt", str(tag / "epoch000.pt")])
    assert torch.equal(torch.load(str(tag / "final.pt"), weights_only=True)
                       ["model_state_dict"]["backbone.body.layer2.0.conv1.weight"],
                       sd["backbone.body.layer2.0.conv1.weight"])


def test_train_movingfashion_synthetic_auto_resumes_and_evaluates(in_tmp, monkeypatch, capsys):
    """One product batch an epoch: a run stopped after its mid save finishes
    under ``--auto_resume`` (the batch skipped), evaluates, and writes
    final.pt, which ``evaluate_movingfashion --ckpt_path`` reads."""
    # --synthetic puts its save_dir under its fixture's directory: one
    # directory for both runs
    root = in_tmp / "seam_synth_mf_run"
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(root))
    root.mkdir()
    argv = ["--synthetic", "--device", "cpu", "--save_steps", "1", "--log_dir",
            str(in_tmp / "runs")]
    with monkeypatch.context() as m:
        _stop_after_first_mid_save(m)
        with pytest.raises(Stop):
            train_movingfashion.main(argv)
    tag = root / "ckpt" / "seam_mf"
    assert sorted(os.listdir(tag)) == ["mid.pt"]
    assert train_movingfashion.main(argv + ["--auto_resume"]) is None
    out = capsys.readouterr().out
    assert "mid-epoch resume: epoch 0, skipping 1 batches" in out
    assert "epoch 0: single/avg/aggr = " in out
    assert sorted(os.listdir(tag)) == ["epoch000.pt", "final.pt"]
    final = restore_checkpoint(str(tag / "final.pt"))
    assert final["epoch"] == 0 and final["optimizer_count"] == 1
    assert any(k.startswith("roi_heads.temporal_aggregator.") for k in final["model_state_dict"])

    monkeypatch.undo()
    monkeypatch.chdir(in_tmp)
    monkeypatch.setattr(evaluate_movingfashion, "serving_model_config", _tiny_model_config)
    res = evaluate_movingfashion.main(["--synthetic", "--device", "cpu", "--ckpt_path",
                                       str(tag / "final.pt")])
    assert len(res) == 3 and all(0.0 <= r <= 1.0 for r in res)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        evaluate_movingfashion.main(["--device", "cpu", "--ckpt_path", str(in_tmp / "nope")])


def test_train_multidf2_synthetic_keeps_the_match_predictor(in_tmp, capsys):
    """The aggregator-only MultiDF2 run leaves the match predictor bit-equal
    and trains only the aggregator; ``evaluate_multidf2`` reads its final.pt."""
    assert train_multidf2.main(["--synthetic", "--device", "cpu", "--log_dir",
                                str(in_tmp / "runs")]) is None
    assert "epoch 0: single/avg/aggr = " in capsys.readouterr().out
    (root,) = [p for p in in_tmp.iterdir() if p.name.startswith("seam_synth_mdf2_")]
    final = restore_checkpoint(str(root / "ckpt" / "seam_mdf2" / "final.pt"))
    sd = final["model_state_dict"]
    init = init_model(_tiny_model_config(), video=True, device="cpu").state_dict()
    mp = [k for k in sd if k.startswith(MP)]
    assert mp and all(torch.equal(sd[k], init[k]) for k in mp)
    n_ta = len(list(init_model(_tiny_model_config(), video=True, device="cpu")
                    .roi_heads["temporal_aggregator"].parameters()))
    assert len(final["optimizer_state_dict"]["param_groups"][0]["params"]) == n_ta
    # the aggregator trained, unless no batch had a usable selection
    ta = [k for k in sd if k.startswith("roi_heads.temporal_aggregator.") and "weight" in k]
    assert final["optimizer_count"] == 0 or any(not torch.equal(sd[k], init[k]) for k in ta)
    res = evaluate_multidf2.main(["--synthetic", "--device", "cpu", "--ckpt_path",
                                  str(root / "ckpt" / "seam_mdf2" / "final.pt")])
    assert len(res) == 3 and all(0.0 <= r <= 1.0 for r in res)


def test_evaluate_multidf2_synthetic(in_tmp):
    res = evaluate_multidf2.main(["--synthetic", "--device", "cpu", "--fp16_gallery"])
    assert len(res) == 3 and all(0.0 <= r <= 1.0 for r in res)
    assert any(p.name.startswith("seam_synth_mdf2_") for p in in_tmp.iterdir())
    assert np.isfinite(res).all()
