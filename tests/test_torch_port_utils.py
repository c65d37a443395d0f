"""The port's ``utils/visualize.py`` and ``utils/profiling.py`` on the CPU.

* Each visualizer renders the same pixels as the JAX package's on the cases
  of tests/test_visualize.py (both PNGs read back with
  ``matplotlib.image.imread``), also when its arrays are torch tensors.
* ``trace(device="cpu")`` writes a Chrome trace into its directory that
  names an ``annotate`` region; without a card, ``trace()`` raises.
"""

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu.utils import visualize as jax_visualize

from seam_match_rcnn_tpu_torch.utils import profiling, visualize

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")
from matplotlib.image import imread  # noqa: E402


def _cases():
    rng = np.random.RandomState(0)
    street, shop = rng.rand(60, 80, 3), rng.rand(60, 80, 3)
    frames = [rng.rand(60, 80, 3) for _ in range(3)]
    r1 = np.random.RandomState(1)
    img = r1.rand(32, 40, 3)
    imgs = [np.random.RandomState(2).rand(32, 40, 3) for _ in range(3)]
    two = np.asarray([[2, 2, 20, 20], [5, 5, 30, 25]], np.float32)
    return {
        "matches": ("visualize_matches", (street, shop, np.asarray([[5.0, 5, 40, 50]]),
                                          np.asarray([[10.0, 8, 45, 55]])),
                    {"scores": np.asarray([0.9])}),
        "matches_matrix": ("visualize_matches", (img, img, np.asarray(
            [[1, 1, 10, 10], [12, 12, 30, 28]], np.float32), np.asarray([[2, 2, 20, 20]],
                                                                        np.float32)),
                           {"scores": r1.rand(2, 3)}),
        "tracking": ("visualize_tracking", (frames, [np.asarray([[5.0 + i, 5, 40, 50]])
                                                     for i in range(3)]),
                     {"tracklet_ids": [np.zeros(1, int)] * 3}),
        "tracking_eval": ("visualize_tracking_eval", (imgs, [two] * 3,
                                                      [np.asarray([0, 1])] * 3), {"rows": 2}),
    }


def _tensors(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (list, tuple)):
        return [_tensors(v) for v in x]
    return x


@pytest.mark.parametrize("case", ["matches", "matches_matrix", "tracking", "tracking_eval"])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_visualizers_render_the_jax_pixels(tmp_path, case, as_tensors):
    name, args, kw = _cases()[case]
    want = getattr(jax_visualize, name)(*args, **kw, out_path=str(tmp_path / "jax.png"))
    if as_tensors:
        args, kw = _tensors(list(args)), {k: _tensors(v) for k, v in kw.items()}
    got = getattr(visualize, name)(*args, **kw, out_path=str(tmp_path / "port.png"))
    assert got == str(tmp_path / "port.png")
    a, b = imread(want), imread(got)
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_array_equal(a, b)


def test_visualize_matches_refuses_scores_of_another_length(tmp_path):
    img = torch.rand(32, 40, 3)
    with pytest.raises(ValueError):
        visualize.visualize_matches(img, img, torch.tensor([[1.0, 1, 10, 10]] * 2),
                                    torch.tensor([[2.0, 2, 20, 20]]),
                                    scores=torch.tensor([0.5]), out_path=str(tmp_path / "m.png"))


def test_trace_cpu_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("seam_probe_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "seam_probe_region" in files[0].read_text()


def test_trace_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path)):
            pass
    with pytest.raises(ValueError, match="device"):
        with profiling.trace(str(tmp_path), device="tpu"):
            pass
