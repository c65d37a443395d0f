"""The phase-2 warm start and the torch-file entry to serving, against the
JAX package: ``load_pretrained_detector`` (with ``clone_match_to_aggregator``)
on the port's own random state dict equals JAX's ``convert_state_dict(...,
video=True, clone_match_to_aggregator=...)`` carried back into the port by
``ckpt/from_jax``; ``SeamRetrieval.from_checkpoint`` serves a saved file."""

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.ckpt.torch_convert import _fresh_aggregator_extras, convert_state_dict

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.ckpt.torch_convert import (clone_match_to_aggregator,
                                                          fresh_aggregator_extras,
                                                          load_pretrained_detector,
                                                          unwrap_state_dict)
from seam_match_rcnn_tpu_torch.config import ModelConfig, RoIHeadsConfig
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.serving import SeamRetrieval

MP, TA = "roi_heads.match_predictor.", "roi_heads.temporal_aggregator."
CFG = ModelConfig(roi_heads=RoIHeadsConfig(detections_per_img=10))


@pytest.fixture(scope="module")
def source():
    """A video model's state dict with every head tensor drawn (so that the
    match predictor and the aggregator differ everywhere, NLB included)."""
    model = init_model(CFG, video=True, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.startswith(("roi_heads.match_predictor", "roi_heads.temporal_aggregator")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05)
        for m in ("match_predictor", "temporal_aggregator"):
            bn = model.roi_heads[m].linear[1]
            bn.running_mean.copy_(torch.randn(256, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(256, generator=gen) + 0.5)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _via_jax(sd, clone):
    """The JAX converter's variables, carried into a fresh port model."""
    variables = convert_state_dict({k: v.numpy() for k, v in sd.items()}, video=True,
                                   clone_match_to_aggregator=clone)
    return load_jax_variables(init_model(CFG, video=True, seed=7, device="cpu"), variables)


def _heads(model):
    return {k: v for k, v in model.state_dict().items()
            if k.startswith("roi_heads.") and not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("clone", [True, False])
def test_load_pretrained_detector_matches_jax_convert(source, clone):
    """A checkpoint with aggregator keys: its aggregator as saved, or (clone)
    with the trunk, ``last`` and statistics of its match predictor, the NLB
    and attention as saved.  The ``module.`` prefix and the CLI wrapper go."""
    wrapped = {"epoch": 3, "model_state_dict": {f"module.{k}": v for k, v in source.items()}}
    got = load_pretrained_detector(wrapped, init_model(CFG, video=True, seed=5, device="cpu"),
                                   clone_match_to_aggregator=clone)
    want = _via_jax(source, clone)
    g, w = _heads(got), _heads(want)
    assert g.keys() == w.keys()
    for k in w:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
    for k, v in unwrap_state_dict(source).items():  # the rest loads as saved
        if not k.startswith("roi_heads."):
            assert torch.equal(got.state_dict()[k], v), k
    ta = got.roi_heads["temporal_aggregator"]
    assert torch.equal(ta.newnlb.theta.weight, source[TA + "newnlb.theta.weight"])
    assert torch.equal(ta.linear[1].running_var,
                       source[(MP if clone else TA) + "linear.1.running_var"])


def test_detector_without_aggregator_is_cloned_whatever_the_flag(source):
    """A phase-1 (image model) checkpoint: the aggregator's trunk, ``last``
    and statistics come from its match predictor and its NLB and attention
    are the JAX converter's fresh draw, so the whole aggregator equals
    JAX's, whatever the model held before."""
    sd = {k: v for k, v in source.items() if not k.startswith(TA)}
    got = load_pretrained_detector(sd, init_model(CFG, video=True, seed=5, device="cpu"),
                                   clone_match_to_aggregator=False)
    want = _via_jax(sd, False)
    g, w = _heads(got), _heads(want)
    assert g.keys() == w.keys()
    for k in w:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(got.roi_heads["temporal_aggregator"].newnlb.theta.weight,
                           init_model(CFG, video=True, seed=5, device="cpu").roi_heads[
                               "temporal_aggregator"].newnlb.theta.weight)


def test_fresh_aggregator_extras_match_jax():
    """The port's draw of the fresh NLB and attention equals the JAX
    converter's ``_fresh_aggregator_extras``, leaf by leaf, through the
    JAX-to-port layout of ``ckpt/from_jax``."""
    want = _fresh_aggregator_extras()
    got = fresh_aggregator_extras()
    assert len(got) == 11
    torch.testing.assert_close(got[TA + "attention_scorer.weight"],
                               torch.from_numpy(want["attention_scorer"]["kernel"].T),
                               rtol=0, atol=0)
    for jname, tname in (("theta", "theta"), ("phi", "phi"), ("g", "g"), ("w_z", "W")):
        torch.testing.assert_close(got[f"{TA}newnlb.{tname}.weight"],
                                   torch.from_numpy(want["nlb"][jname]["kernel"].T[:, :, None]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(got[f"{TA}newnlb.{tname}.bias"],
                                   torch.from_numpy(want["nlb"][jname]["bias"]), rtol=0, atol=0)
    torch.testing.assert_close(got[TA + "newnlb.concat_project.0.weight"],
                               torch.from_numpy(want["nlb"]["concat_w"].T[:, :, None, None]),
                               rtol=0, atol=0)


def test_clone_match_to_aggregator_copies_trunk_last_and_statistics(source):
    model = init_model(CFG, video=True, seed=5, device="cpu")
    model.load_state_dict(source)
    clone_match_to_aggregator(model)
    sd = model.state_dict()
    cloned = [k for k in sd if k.startswith(TA) and MP + k[len(TA):] in sd]
    assert len(cloned) == 17  # 4 convs x 2, linear 2, BN 5 (num_batches_tracked too), last 2
    for k in cloned:
        assert torch.equal(sd[k], sd[MP + k[len(TA):]]), k
    for k in sd:
        if k.startswith(TA) and k not in cloned:
            assert torch.equal(sd[k], source[k]), k


def test_load_pretrained_detector_refuses_keys_that_do_not_fit(source):
    model = init_model(CFG, video=True, seed=5, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_pretrained_detector({k: v for k, v in source.items()
                                  if not k.startswith("rpn.")}, model)
    with pytest.raises(ValueError, match="unexpected"):
        load_pretrained_detector(dict(source, extra=torch.zeros(1)), model)


def test_seam_retrieval_from_checkpoint(source, tmp_path):
    path = tmp_path / "seam.pth"
    torch.save({"epoch": 0, "model_state_dict": source}, path)
    retr = SeamRetrieval.from_checkpoint(str(path), cfg=CFG, device="cpu", chunk=3)
    sd = retr.model.state_dict()
    for k, v in source.items():
        assert torch.equal(sd[k], v), k
    assert retr.runner.chunk == 3 and retr.model.video
    np.testing.assert_array_equal(retr._aw.numpy(), source[TA + "last.weight"].numpy())
    with pytest.raises(NotImplementedError, match="ckpt/io"):
        SeamRetrieval.from_checkpoint(str(tmp_path), cfg=CFG, device="cpu")
