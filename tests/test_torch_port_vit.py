"""The port's ViTDet backbone (``models/vit.py``) against the plain reference
``tests/reference_vitdet.py`` on seeded weights at a tiny size: a ViT of 64
channels, 4 heads and 4 blocks, block 3 global and the others in windows of
3 x 3 tokens over an 8 x 8 grid (so the grid is zero-padded to 9 x 9 and the
padded tokens are keys), with non-zero qkv biases (so a masked pad key would
show), and its simple feature pyramid to P2-P6.  Then the whole
``MatchRCNN(backbone="vitdet_l")`` against the benchmark's reference model, the
two reference copies against each other, and the benchmark configurations'
keys against the port's ``ModelConfig``."""

import dataclasses
import json
import pathlib
import typing

import numpy as np
import pytest
import torch

from portbench import model as M
from portbench.entries import index_vitdet
from portbench.reference import transform as rt
from portbench.reference import vitdet as bench_ref
from seam_match_rcnn_tpu_torch.config import ModelConfig, TransformConfig, ViTConfig
from seam_match_rcnn_tpu_torch.models.vit import ViTDetBackbone

import reference_vitdet as ref

TINY = ViTConfig(img_size=128, embed_dim=64, depth=4, num_heads=4, window_size=3,
                 window_block_indexes=(0, 1, 2), pretrain_img_size=64)
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs"


def _state(module: torch.nn.Module, seed: int) -> dict:
    """Every tensor drawn N(0, 1/fan-in) (LayerNorm weights 1 + N(0, 0.1),
    biases N(0, 0.1)), so padded keys carry qkv's bias."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias" or t.dim() == 1:
            v = torch.randn(t.shape, generator=g) * 0.1 + (1.0 if leaf == "weight" else 0.0)
        else:
            v = torch.randn(t.shape, generator=g) * t[0].numel() ** -0.5
        out[name] = v
    return out


def _pair(dtype):
    port = ViTDetBackbone(TINY, dtype)
    plain = ref.ViTDetBackbone(TINY)
    state = _state(plain, 7)
    port.load_state_dict(state, strict=True)
    plain.load_state_dict(state, strict=True)
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        return port(x), plain(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_matches_the_reference(dtype):
    """P2-P6 at strides 4-64 with 256 channels.  In float32 the two agree to
    the order of their sums.  In the port's bf16 configuration every dense
    layer and conv rounds its inputs and weights to bf16 (2^-9 relative each),
    K9's plain version takes bf16 q, k and v, and the errors add over 4 blocks
    and the pyramid's 2-4 convs: each level stays within 3% of its norm (it
    reads 0.7-0.9%; masking the padded keys moves the levels by 13-22%)."""
    got, want = _pair(getattr(torch, dtype))
    assert [tuple(f.shape) for f in got] == [(2, 256, 128 // s, 128 // s)
                                             for s in (4, 8, 16, 32, 64)]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert float((g.float() - w).norm() / w.norm()) < 0.03


def _block_with_pad_keys_masked(self, t):
    """``reference_vitdet.Block.forward`` with the padded keys of each window
    masked out of the softmax, the departure the f32 comparison must see."""
    if self.window_size == 0:
        return _BLOCK_FORWARD(self, t)
    a, s = self.attn, self.window_size
    h, w = t.shape[1], t.shape[2]
    wins, pad_hw = ref.window_partition(self.norm1(t), s)
    pad = torch.ones(pad_hw)
    pad[:h, :w] = 0
    pad = ref.window_partition(pad[None, :, :, None], s)[0].reshape(-1, s * s)
    pad = pad.repeat(t.shape[0], 1) > 0  # windows in (image, row, column) order
    n = wins.shape[0]
    qkv = a.qkv(wins).reshape(n, s * s, 3, a.num_heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, n * a.num_heads, s * s, -1).unbind(0)
    attn = ref.add_decomposed_rel_pos((q * a.scale) @ k.transpose(-2, -1), q, a.rel_pos_h,
                                      a.rel_pos_w, (s, s))
    attn = attn.masked_fill(pad.repeat_interleave(a.num_heads, 0)[:, None, :], float("-inf"))
    o = (attn.softmax(-1) @ v).view(n, a.num_heads, s, s, -1).permute(0, 2, 3, 1, 4)
    t = t + ref.window_unpartition(a.proj(o.reshape(n, s, s, -1)), s, pad_hw, (h, w))
    return t + self.mlp(self.norm2(t))


_BLOCK_FORWARD = ref.Block.forward


def test_a_masked_pad_key_would_show(monkeypatch):
    """Masking the padded keys of the windowed blocks moves every level far
    beyond the float32 tolerance above."""
    plain = ref.ViTDetBackbone(TINY)
    plain.load_state_dict(_state(plain, 7), strict=True)
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = plain(x)
        monkeypatch.setattr(ref.Block, "forward", _block_with_pad_keys_masked)
        masked = plain(x)
    gaps = [float((m - w).abs().max()) for m, w in zip(masked, want)]
    assert min(gaps) > 1e-2, gaps


def test_the_two_reference_copies_agree():
    """``tests/reference_vitdet.py`` and the benchmark's ``reference/vitdet.py``
    (on its dtype-aware layers, here in float32) give the same pyramid."""
    a = ref.ViTDetBackbone(TINY)
    b = bench_ref.ViTDetBackbone(bench_ref.ViTConfig(**dataclasses.asdict(TINY)), torch.float32)
    state = _state(a, 11)
    a.load_state_dict(state, strict=True)
    b.load_state_dict(state, strict=True)
    x = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p, q in zip(a(x), b(x)):
            torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5)


def _tiny_cell() -> dict:
    cfg = json.loads((CONFIGS / "seam_vitdet_l.json").read_text())
    m = cfg["model"]
    m.update(compute_dtype="float32", vit=dataclasses.asdict(TINY))
    m["transform"].update(min_size=128, max_size=128, square_pad=128)
    m["rpn"].update(pre_nms_top_n_test=60, post_nms_top_n_test=120)
    m["roi_heads"].update(detections_per_img=6, roi_align_backend="xla")
    m["match"].update(nlb_backend="xla")
    return cfg


def test_whole_model_matches_the_reference_detections():
    """``MatchRCNN(ModelConfig(backbone="vitdet_l", ...), video=True)`` in
    float32 on a 128 x 128 square canvas against the benchmark's reference
    model on the same weights: detections and match descriptors."""
    cfg = _tiny_cell()
    port = M.port_model(cfg, 5, "cpu")
    assert isinstance(port.backbone, ViTDetBackbone)
    plain = index_vitdet.reference_model(cfg, 5, "cpu")
    img = np.random.RandomState(2).randint(0, 256, (90, 70, 3)).astype(np.uint8)
    canvas, (nh, nw) = rt.ingest(img, plain.cfg.transform, "cpu")
    assert canvas.shape[2:] == (128, 128) and max(nh, nw) == 128
    sizes = torch.tensor([[nh, nw]])
    with torch.no_grad():
        out = port.inference(canvas, sizes)
        feats, det = plain.detect(canvas, sizes)
    assert bool(det.valid.any())
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_allclose(out[k].numpy(), getattr(det, k).numpy(), rtol=1e-4,
                                   atol=1e-4)
    roi = plain.roi_features(feats, det.boxes)
    np.testing.assert_allclose(out["match_features"][0].numpy(),
                               plain.match_descriptors(roi).numpy(), rtol=1e-4, atol=1e-4)


def test_vitdet_options_are_checked():
    from seam_match_rcnn_tpu_torch.models.matchrcnn import MatchRCNN

    with torch.device("meta"):
        for kw in ({"backbone": "resnet101"}, {"backbone": "vitdet_l", "stem_backend": "pallas"}):
            with pytest.raises(ValueError):
                MatchRCNN(ModelConfig(**kw))
    assert TransformConfig(square_pad=1024).portrait_canvas == (1024, 1024)
    assert TransformConfig().portrait_canvas == (1344, 800)


def _unknown_keys(cls, d: dict, path=""):
    hints = typing.get_type_hints(cls)
    names = {f.name: hints[f.name] for f in dataclasses.fields(cls)}
    out = []
    for k, v in d.items():
        if k not in names:
            out.append(path + k)
        elif dataclasses.is_dataclass(names[k]) and isinstance(v, dict):
            out += _unknown_keys(names[k], v, f"{path}{k}.")
    return out


@pytest.mark.parametrize("name", sorted(p.stem for p in CONFIGS.glob("*.json")))
def test_every_configuration_key_is_a_port_field(name):
    """The harness builds the port's ``ModelConfig`` from a configuration's
    ``model`` object and skips keys the dataclass lacks: every key must be a
    field, at every depth, or the port would run another model silently."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    assert _unknown_keys(ModelConfig, cfg["model"]) == []
