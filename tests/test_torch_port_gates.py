"""The port's serving-profile validation tools against the JAX tools.

``tools/_synth_train_torch.py`` and the four gates built on it
(``validate_int8_torch.py``, ``validate_fast_profile_torch.py``,
``validate_trunk_dtype_torch.py``, ``measure_roi_clamp_torch.py``) on the
CPU, at small sizes: the numpy helpers are the JAX tools' own code and give
their outputs; the clamp mask, the synthetic schedule and the video warm
start equal the JAX ones; the two probes agree with the JAX tool's on the
same weights (JAX variables carried across by
``ckpt/from_jax.load_jax_variables``) and the same seeded images, at the
1e-3 of the port's other forward-parity tests (f32 on both sides; XLA and
oneDNN sum the convolutions in different orders); the gates' parsers carry
the JAX tools' flags and defaults plus ``--device``, which raises without
a card; and one CPU rehearsal of the int8 gate prints the JAX tool's JSON
line.  No JAX training runs: the JAX side is only initialised.
"""

import argparse
import ast
import dataclasses
import importlib
import inspect
import json
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import seam_match_rcnn_tpu  # noqa: E402
import seam_match_rcnn_tpu_torch  # noqa: E402


def _import_jax_tool(name):
    """Import a JAX tool from this checkout, then put ``sys.path`` back as it
    was: the JAX tools put a fixed repo path at its front when they load.
    Both packages are loaded above, so their imports resolve here too."""
    saved = list(sys.path)
    try:
        return importlib.import_module(name)
    finally:
        sys.path[:] = saved


jax_st = _import_jax_tool("tools._synth_train")
jax_clamp = _import_jax_tool("tools.measure_roi_clamp")
jax_vf = _import_jax_tool("tools.validate_fast_profile")
jax_vi = _import_jax_tool("tools.validate_int8")
jax_vt = _import_jax_tool("tools.validate_trunk_dtype")

import tools._synth_train_torch as st  # noqa: E402
import tools.measure_roi_clamp_torch as clamp  # noqa: E402
import tools.validate_fast_profile_torch as vf  # noqa: E402
import tools.validate_int8_torch as vi  # noqa: E402
import tools.validate_trunk_dtype_torch as vt  # noqa: E402

from seam_match_rcnn_tpu import config as jax_config  # noqa: E402
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init  # noqa: E402
from seam_match_rcnn_tpu.train.optim import multistep_warmup_schedule  # noqa: E402

from seam_match_rcnn_tpu_torch import config  # noqa: E402
from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables  # noqa: E402
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model  # noqa: E402
from torch_port_canvas import Canvas64x96, small_canvas  # noqa: E402

torch.set_num_threads(2)

JaxCanvas64x96 = small_canvas(jax_config.TransformConfig, (64, 96))


def test_everything_loads_from_this_checkout():
    """The packages and the tools on both sides are this checkout's."""
    mods = (seam_match_rcnn_tpu, seam_match_rcnn_tpu_torch, jax_st, jax_clamp, jax_vf, jax_vi,
            jax_vt, st, clamp, vf, vi, vt, jax_config, config)
    for mod in mods:
        assert Path(mod.__file__).resolve().is_relative_to(ROOT), (mod.__name__, mod.__file__)


# ---- the copied numpy helpers ------------------------------------------------------------

def _code(fn):
    """A function's code without its docstring, as an AST dump."""
    node = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    if ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name,port,jax_tool", [
    ("all_strategy_top1", st, jax_st), ("confusable_palette", st, jax_st),
    ("margin_analysis", st, jax_st), ("compare_probes", st, jax_st),
    ("anchor_distribution", clamp, jax_clamp)])
def test_copied_helper_is_the_jax_tools_code(name, port, jax_tool):
    assert _code(getattr(port, name)) == _code(getattr(jax_tool, name))


@pytest.mark.parametrize("products,kw", [(1, {}), (7, {}), (64, {}), (9, {"delta": 18}),
                                         (5, {"seed": 3})])
def test_confusable_palette_as_the_jax_tool(products, kw):
    assert st.confusable_palette(products, **kw) == jax_st.confusable_palette(products, **kw)


def _probe_out(rng, n, kept):
    scores = rng.randn(n, n)
    ranks = np.asarray([int(np.sum(r > r[i])) for i, r in enumerate(scores)])
    margins = np.asarray([r[i] - np.max(np.delete(r, i)) for i, r in enumerate(scores)])
    return {"scores": scores, "ranks": ranks, "margins": margins, "kept": kept}


def test_margin_analysis_and_compare_probes_as_the_jax_tool():
    rng = np.random.RandomState(0)
    base = _probe_out(rng, 6, list(range(6)))
    other = dict(base, scores=base["scores"] + 0.01 * rng.randn(6, 6),
                 ranks=np.asarray([0, 1, 0, 2, 0, 0]))
    cases = [(base, base), (base, other), (base, {"kept": [0, 1]}), ({"kept": [0]}, {"kept": [0]})]
    for a, b in cases:
        assert st.margin_analysis(a, b) == jax_st.margin_analysis(a, b)
    assert st.margin_analysis(base, other)["n_flips"] > 0
    pa = {"desc": rng.randn(5, 8).astype(np.float32), "scores": rng.rand(5).astype(np.float32)}
    pb = {"desc": pa["desc"] + 0.25, "scores": pa["scores"] * 0.5}
    empty = {"desc": np.zeros((0, 8), np.float32), "scores": np.zeros((0,), np.float32)}
    for a, b in [(pa, pa), (pa, pb), (pa, dict(pb, desc=pb["desc"][:-1])), (empty, empty)]:
        assert st.compare_probes(a, b) == jax_st.compare_probes(a, b)


def test_all_strategy_top1_as_the_jax_tool(tmp_path):
    mf = {s: {"1": 0.25 * i, "5": 0.5, "10": 0.75, "20": 1.0}
          for i, s in enumerate(("sfmr", "product_max", "avg_desc", "aggr_desc", "avg_dist",
                                 "max_dist", "max_score"))}
    for name, metrics in (("mf", {"all": mf, "regular": mf, "hard": {}}), ("flat", mf),
                          ("mixed", {"all": dict(mf, note="x")})):
        out = tmp_path / name
        out.mkdir()
        (out / "metrics.json").write_text(json.dumps(metrics))
        got = st.all_strategy_top1(str(out))
        assert got == jax_st.all_strategy_top1(str(out))
        assert set(got) == set(mf) and got["avg_desc"] == 0.5


# ---- the clamp measurement ---------------------------------------------------------------

def test_anchor_distribution_and_clamp_mask_equal_jax():
    rois = clamp.anchor_distribution(2000, 0.4)
    np.testing.assert_array_equal(rois, jax_clamp.anchor_distribution(2000, 0.4))
    got = clamp.clamp_mask(rois, "cpu")
    want = jax_clamp.clamp_mask(rois)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and 0 < got.sum() < len(rois)


def test_clamp_tool_prints_the_jax_tools_lines(capsys):
    clamp.main(["--n", "2000", "--device", "cpu"])
    got = capsys.readouterr().out
    jax_clamp.analytic_boundary()
    for sigma in (0.0, 0.2, 0.4):
        frac = jax_clamp.clamp_mask(jax_clamp.anchor_distribution(2000, sigma)).mean()
        print(f"anchor distribution (jitter sigma={sigma}): "
              f"clamp fraction = {frac:.2e}  ({int(frac * 2000)}/2000)")
    assert got == capsys.readouterr().out
    assert "s= 27.9 cells: aspect >= 2.00 clamps" in got


# ---- flags, defaults and --device --------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch, argv=()):
    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main(*argv)
    return seen["parser"]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.const,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_tool", [(vi, jax_vi), (vf, jax_vf), (vt, jax_vt),
                                           (clamp, jax_clamp)])
def test_gate_parser_carries_the_jax_tools_flags(port, jax_tool, monkeypatch):
    got = _flags(_parser_of(port.main, monkeypatch, ([],)))
    want = _flags(_parser_of(jax_tool.main, monkeypatch))
    assert got.pop("device") == (("--device",), "cuda", str, None, None, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("main,argv", [(vi.main, ["--products", "2"]), (vf.main, []),
                                       (vt.main, []), (clamp.main, ["--n", "10"])])
def test_gate_raises_on_cuda_without_a_card(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trained = []
    monkeypatch.setattr(st, "train_synthetic_phase1", lambda *a, **k: trained.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not trained


# ---- the schedule, the warm start and the probes against JAX ------------------------------

@pytest.mark.parametrize("lr,epochs,steps", [(0.001, 8, 128), (0.001, 6, 3), (0.01, 1, 4),
                                             (0.001, 3, 1), (0.002, 2, 70)])
def test_synthetic_schedule_equals_jax_step_for_step(lr, epochs, steps):
    """The JAX tool's schedule (tools/_synth_train.py:59-64); JAX computes it
    in f32, so each step agrees within rtol 1e-6."""
    mine = st.synthetic_schedule(lr, epochs, steps)
    theirs = multistep_warmup_schedule(lr, (max(epochs - 2, 1),), 0.1, steps,
                                       min(60, steps * (epochs - 1)), 1e-2)
    got = np.asarray([mine(i) for i in range(steps * epochs + 3)])
    want = np.asarray([float(theirs(i)) for i in range(steps * epochs + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tiny(module, canvas):
    """The tiny_video_model geometry of tests/test_e2e.py (f32, small RPN and
    detection caps, the plain paths) on a 64x96 canvas, in ``module``'s
    config classes."""
    return module.ModelConfig(
        rpn=module.RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
        roi_heads=module.RoIHeadsConfig(detections_per_img=8, score_thresh=0.01),
        transform=canvas(min_size=64, max_size=96), compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_video():
    cfg = _tiny(jax_config, JaxCanvas64x96)
    model, variables = jax_init(cfg, video=True, canvas=(64, 96))
    return model, jax.tree.map(np.asarray, variables)


def test_video_vars_equals_the_jax_warm_start(jax_video):
    """A "trained" phase-1 state (the JAX init, every leaf scaled so that a
    copy shows) through both warm starts: every tensor the port copies equals
    the JAX one, and the aggregator's trunk, ``last`` and BatchNorm statistics
    equal the match predictor's; the NLB and the attention are each
    package's own init."""
    _, variables = jax_video
    trained = {col: {k: jax.tree.map(lambda a: a * 1.5 + 0.25, v)
                     for k, v in variables[col].items() if k != "temporal_aggregator"}
               for col in ("params", "batch_stats")}
    vv = jax.tree.map(np.asarray, jax_st.video_vars(_tiny(jax_config, JaxCanvas64x96), trained))
    cfg = _tiny(config, Canvas64x96)
    want = load_jax_variables(init_model(cfg, video=True, device="cpu"), vv).state_dict()
    # the JAX video tree minus the aggregator is a phase-1 tree
    port_trained = load_jax_variables(init_model(cfg, device="cpu"), trained).state_dict()
    got = st.video_vars(cfg, port_trained, device="cpu").state_dict()

    own_init = ("roi_heads.temporal_aggregator.attention_scorer.",
                "roi_heads.temporal_aggregator.newnlb.")
    assert set(got) == set(want)
    compared = 0
    for k, v in got.items():
        if k.startswith(own_init) or k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
        compared += 1
    assert compared > 300
    ta = [k for k in got if k.startswith("roi_heads.temporal_aggregator.")
          and not k.startswith(own_init) and not k.endswith("num_batches_tracked")]
    assert len(ta) > 10 and any("running_var" in k for k in ta)
    for k in ta:
        twin = k.replace("temporal_aggregator", "match_predictor")
        assert torch.equal(got[k], got[twin]), k
        assert torch.equal(got[k], port_trained[twin]), k


def test_probes_agree_with_the_jax_tools(jax_video):
    """``descriptor_probe`` on two seeded images and ``rank_margin_probe`` over
    three seeded products (a shop image and one frame each), on the JAX
    variables: the same detections, descriptors and scores within 1e-3, the
    same kept products and ranks, margins within 1e-3."""
    jmodel, variables = jax_video
    port = load_jax_variables(init_model(_tiny(config, Canvas64x96), video=True, device="cpu"),
                              variables)
    rng = np.random.RandomState(5)
    images = [rng.rand(60, 80, 3).astype(np.float32) for _ in range(2)]
    got = st.descriptor_probe(port, images)
    want = jax_st.descriptor_probe(jmodel, variables, images)
    assert got["desc"].shape == want["desc"].shape and got["desc"].shape[0] > 0
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-3, atol=1e-3)

    products = [{"images": [rng.rand(60, 80, 3).astype(np.float32) for _ in range(2)]}
                for _ in range(3)]
    got = st.rank_margin_probe(port, products)
    want = jax_st.rank_margin_probe(jmodel, variables, products)
    assert got["kept"] == want["kept"] and len(got["kept"]) >= 2
    np.testing.assert_array_equal(got["ranks"], want["ranks"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["margins"], want["margins"], rtol=1e-3, atol=1e-3)


# ---- a rehearsal of the int8 gate ----------------------------------------------------------

def _shrunk(cfg):
    """A 64x96 canvas, f32 and few rois: the full model's width, a CPU's size."""
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        rpn=dataclasses.replace(cfg.rpn, pre_nms_top_n_train=40, post_nms_top_n_train=40,
                                pre_nms_top_n_test=30, post_nms_top_n_test=30,
                                batch_size_per_image=16),
        roi_heads=dataclasses.replace(cfg.roi_heads, batch_size_per_image=16,
                                      detections_per_img=4, score_thresh=0.01),
        transform=Canvas64x96(min_size=64, max_size=96))


def test_int8_gate_rehearsal_prints_the_jax_tools_json(monkeypatch, capsys):
    monkeypatch.setattr(st, "ModelConfig", lambda **kw: _shrunk(config.ModelConfig(**kw)))
    monkeypatch.setattr(vi, "serving_model_config",
                        lambda **kw: _shrunk(config.serving_model_config(**kw)))
    vi.main(["--products", "2", "--epochs", "1", "--frames", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    [line] = [ln for ln in out.splitlines() if ln.startswith("INT8VAL_JSON ")]
    payload = json.loads(line[len("INT8VAL_JSON "):])
    base = "pallas_resident"
    assert set(payload) == {"results", f"deltas_vs_{base}", f"probe_drift_vs_{base}",
                            f"rank_margin_vs_{base}", "confusable", "products", "frames"}
    assert (payload["confusable"], payload["products"], payload["frames"]) == (False, 2, 2)
    backends = ["pallas_resident", "pallas", "pallas_int8"]
    assert list(payload["results"]) == backends
    strategies = {"sfmr", "product_max", "avg_desc", "aggr_desc", "avg_dist", "max_dist",
                  "max_score"}
    for bk in backends:
        assert set(payload["results"][bk]) == {"mf", "mdf2"}
        assert set(payload["results"][bk]["mf"]) == strategies
        assert f"[{bk}] MF top-1: " in out and f"[{bk}] MDF2 top-1: " in out
    for key in (f"deltas_vs_{base}", f"probe_drift_vs_{base}", f"rank_margin_vs_{base}"):
        assert list(payload[key]) == backends[1:]
    assert set(payload[f"probe_drift_vs_{base}"]["pallas"]) <= {
        "desc_max_abs", "desc_mean_abs", "score_max_abs", "n_detections",
        "detection_sets_diverged", "n_a", "n_b"}
