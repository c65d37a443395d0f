"""The port's AOT serving export (``tools/export_serving_torch.py``) against
the JAX package's ``jax.export`` roundtrip (``tests/test_export.py``), on
the CPU.

Config of ``tests/test_export.py``: RPN 30/40 proposals, 4 detections, f32,
a 64x64 canvas; ``inference(with_masks=True, with_match=True,
with_roi_features=False)``.  Both sides share the weights through the bridge
(``ckpt/from_jax``) and take the same seeded numpy inputs.  The forward
kernels are the custom ops ``seam::fused_stem``, ``seam::roi_align``,
``seam::roi_align_patch``, ``seam::roi_align_patch_int8`` and
``seam::bn_epilogue`` (with ``seam::bn_epilogue_backward``); on the CPU each
runs its plain version.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seam_match_rcnn_tpu.config import ModelConfig as JaxModelConfig
from seam_match_rcnn_tpu.config import RoIHeadsConfig as JaxRoIHeadsConfig
from seam_match_rcnn_tpu.config import RPNConfig as JaxRPNConfig
from seam_match_rcnn_tpu.models.matchrcnn import MatchRCNN as JaxMatchRCNN
from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.ops.nms import nms_kept_mask as jax_nms_kept

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.config import (ModelConfig, RoIHeadsConfig, RPNConfig,
                                              serving_model_config)
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.ops.nms import nms_kept_mask
from seam_match_rcnn_tpu_torch.ops import cuda_epilogue, cuda_roi_align, cuda_stem
from seam_match_rcnn_tpu_torch.ops import roi_align_patch as patch
from seam_match_rcnn_tpu_torch.ops.roi_align import SPATIAL_SCALES, multilevel_roi_align
from seam_match_rcnn_tpu_torch.ops.roi_align_patch import quantize_features_int8

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import export_serving_torch as est  # noqa: E402

torch.set_num_threads(2)

H = W = 64
RPN = dict(pre_nms_top_n_test=30, post_nms_top_n_test=40)


def port_inputs():
    rng = np.random.RandomState(0)
    images = rng.rand(1, H, W, 3).astype(np.float32)
    sizes = np.asarray([[H, W]], np.int32)
    return images, sizes, (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                           torch.from_numpy(sizes))


def test_export_roundtrip_matches_jax_export(tmp_path):
    """The port's torch.export roundtrip (save, load, replay) and the JAX
    jax.export roundtrip agree: valid and labels equal, the rest within the
    1e-3 of tests/test_torch_port_slice.py (f32 convolutions summed in
    another order through 50 layers)."""
    cfg = JaxModelConfig(rpn=JaxRPNConfig(**RPN),
                         roi_heads=JaxRoIHeadsConfig(detections_per_img=4),
                         compute_dtype="float32")
    jmodel, variables = jax_init(cfg, video=True, canvas=(H, W))
    images, sizes, (timages, tsizes) = port_inputs()

    def fn(variables, images, sizes):
        return jmodel.apply(variables, images, sizes, method=JaxMatchRCNN.inference,
                            with_masks=True, with_match=True, with_roi_features=False)

    exported = jax.export.export(jax.jit(fn))(variables, jnp.asarray(images),
                                              jnp.asarray(sizes))
    back = jax.export.deserialize(bytearray(exported.serialize()))
    want = jax.tree.map(np.asarray, back.call(variables, jnp.asarray(images),
                                              jnp.asarray(sizes)))

    port_cfg = ModelConfig(rpn=RPNConfig(**RPN), roi_heads=RoIHeadsConfig(detections_per_img=4),
                           compute_dtype="float32")
    model = load_jax_variables(init_model(port_cfg, video=True, device="cpu"), variables)
    program = est.export(est.ServingForward(model), (timages, tsizes))
    path = tmp_path / "serving.pt2"
    torch.export.save(program, str(path))
    loaded = est.load(str(path))
    # ModelConfig(): the plain stem and RoIAlign, as the JAX tool's; K8 after each
    # conv of the backbone (16 bottlenecks x 3, the stem's FrozenBN)
    assert est.seam_ops(loaded) == {"seam.bn_epilogue.default": 49}
    with torch.no_grad():
        got = {k: v.numpy() for k, v in loaded.module()(timages, tsizes).items()}

    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "masks",
                                     "match_features"}
    v = want["valid"][0]
    np.testing.assert_array_equal(got["valid"][0], v)
    assert v.sum() >= 1
    np.testing.assert_array_equal(got["labels"][0][v], want["labels"][0][v])
    tol = dict(rtol=1e-3, atol=1e-3)
    for k in ("boxes", "scores", "masks", "match_features"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k][0][v], want[k][0][v], err_msg=k, **tol)


def test_serving_export_keeps_the_kernel_ops_and_replays_bit_equal():
    """Under serving_model_config() the exported graph calls seam::fused_stem
    once, seam::roi_align twice (box branch, 14x14 pass) and
    seam::bn_epilogue after each of the body's 48 convs, the NMS is a
    while_loop node, and the replay equals the eager forward bit for bit."""
    cfg = serving_model_config(rpn=RPNConfig(**RPN),
                               roi_heads=RoIHeadsConfig(detections_per_img=4,
                                                        roi_align_backend="pallas_resident"),
                               compute_dtype="float32")
    model = init_model(cfg, video=True, device="cpu")
    _, _, (timages, tsizes) = port_inputs()
    module = est.ServingForward(model)
    program = est.export(module, (timages, tsizes))
    assert est.seam_ops(program) == {"seam.bn_epilogue.default": 48,
                                     "seam.fused_stem.default": 1,
                                     "seam.roi_align.default": 2}
    loops = [n for n in program.graph.nodes
             if n.op == "call_function" and "while_loop" in str(n.target)]
    assert len(loops) == 2  # the RPN's per-level NMS and the class NMS
    assert [name for name, *_ in est.user_inputs(program)] == ["images", "image_sizes"]
    with torch.no_grad():
        got = program.module()(timages, tsizes)
        want = module(timages, tsizes)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert cuda_stem.fused_stem.launches == 0 and cuda_roi_align.roi_align.launches == 0
    assert cuda_epilogue.bn_epilogue.launches == 0


class KeptMask(torch.nn.Module):
    def forward(self, boxes, scores, valid):
        return nms_kept_mask(boxes, scores, 0.5, valid=valid)


def test_exported_nms_loop_matches_jax_nms():
    """The NMS fixed point is one while_loop node of an exported graph whose
    trip count is the data's: traced on random boxes, the program replays a
    suppression chain (each box overlaps the next, so the loop runs ~48
    rounds) and exactly tied scores bit-equal to the JAX ``nms_kept_mask``
    (the end-to-end comparison above sees only the 4 best detections, which
    the last rounds of the loop never change)."""
    rng = np.random.RandomState(6)
    m, n = 3, 48

    def random_boxes():
        xy = rng.uniform(0, 100, (m, n, 2))
        return np.concatenate([xy, xy + rng.uniform(5, 40, (m, n, 2))], -1).astype(np.float32)

    example = (torch.from_numpy(random_boxes()), torch.from_numpy(rng.rand(m, n).astype(
        np.float32)), torch.ones((m, n), dtype=torch.bool))
    program = torch.export.export(KeptMask(), example, strict=False)
    assert [nd for nd in program.graph.nodes
            if nd.op == "call_function" and "while_loop" in str(nd.target)]
    x = np.arange(n, dtype=np.float32) * 2.0
    chain = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    cases = [(np.stack([chain] * m), np.stack([np.linspace(1.0, 0.5, n, dtype=np.float32)] * m)),
             (random_boxes(), np.round(rng.rand(m, n), 1).astype(np.float32))]
    for boxes, scores in cases:
        valid = rng.rand(m, n) > 0.1
        got = program.module()(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(valid)).numpy()
        for i in range(m):
            want = np.asarray(jax_nms_kept(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5,
                                           valid=jnp.asarray(valid[i])))
            np.testing.assert_array_equal(got[i], want)


def _levels(dtype=torch.float32, c=16):
    g = torch.Generator().manual_seed(3)
    return [torch.randn(2, c, h, w, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last) for h, w in ((32, 40), (16, 20), (8, 10), (4, 5))]


def _rois():
    g = torch.Generator().manual_seed(4)
    xy = torch.rand(2, 6, 2, generator=g) * 100
    return torch.cat([xy, xy + 4 + torch.rand(2, 6, 2, generator=g) * 60], -1).contiguous()


def _op_cases():
    g = torch.Generator().manual_seed(5)
    x = torch.rand(2, 3, 16, 24, generator=g)
    conv_w = torch.randn(64, 3, 7, 7, generator=g) * 0.1
    scale, shift = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.1
    q, qs = quantize_features_int8(_levels())
    sc = list(SPATIAL_SCALES)
    y, res = torch.randn(2, 16, 5, 7, generator=g), torch.randn(2, 16, 5, 7, generator=g)
    cs = [torch.rand(16, generator=g) + 0.5 for _ in range(4)]
    out = cuda_epilogue.bn_epilogue_plain(y, cs[0], cs[1], res, cs[2], cs[3], True)
    grad = torch.randn(2, 16, 5, 7, generator=g)
    return {  # name: (op, its arguments, the plain version's output)
        "bn_epilogue": (torch.ops.seam.bn_epilogue.default,
                        (y.requires_grad_(), cs[0], cs[1], res.requires_grad_(), cs[2], cs[3],
                         True), out),
        "bn_epilogue_backward": (torch.ops.seam.bn_epilogue_backward.default,
                                 (grad, out, cs[0], cs[2], cuda_epilogue.RAW, True),
                                 cuda_epilogue.bn_epilogue_grad_plain(grad, out, cs[0], cs[2],
                                                                      cuda_epilogue.RAW, True)),
        "fused_stem": (torch.ops.seam.fused_stem.default,
                       (x, conv_w, scale, shift, torch.bfloat16),
                       cuda_stem.stem_plain(x, conv_w, scale, shift, torch.bfloat16)),
        "roi_align": (torch.ops.seam.roi_align.default, (_levels(), _rois(), 7, 2, sc),
                      multilevel_roi_align(_levels(), _rois(), 7, 2)),
        "roi_align_patch": (torch.ops.seam.roi_align_patch.default,
                            (_levels(torch.bfloat16), _rois(), 14, 2, sc),
                            patch.roi_align_patch(_levels(torch.bfloat16), _rois(), 14, 2)),
        "roi_align_patch_int8": (torch.ops.seam.roi_align_patch_int8.default,
                                 (list(q), qs, _rois(), 7, torch.float32, 2, sc),
                                 patch.roi_align_patch(list(q), _rois(), 7, 2, scales=qs,
                                                       out_dtype=torch.float32)),
    }


@pytest.mark.parametrize("name", ["fused_stem", "roi_align", "roi_align_patch",
                                  "roi_align_patch_int8", "bn_epilogue",
                                  "bn_epilogue_backward"])
def test_custom_op_passes_opcheck(name):
    """torch.library.opcheck: schema, autograd registration, the fake
    implementation against the CPU one (shape, dtype, strides), and AOT
    dispatch; the CPU implementation is the wrapper's plain version."""
    op, args, plain = _op_cases()[name]
    out = op(*args)
    outs, plains = (out, plain) if isinstance(out, tuple) else ((out,), (plain,))
    assert all(torch.equal(o, p) and o.stride() == p.stride() for o, p in zip(outs, plains))
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    kernels = torch._C._dispatch_dump(str(op._schema.name)).split("\n")
    assert sorted(k.split(":")[0] for k in kernels if "registered at" in k
                  and not k.startswith("debug")) == ["Autograd[alias]", "CPU", "CUDA", "Meta"]
