"""``ops/masks.paste_masks``, port vs JAX, on the same seeded probabilities.

Boxes inside the image, partly outside it and thinner than a pixel (the
JAX function clamps the scaled width and height at 1e-6), pasted at two
output sizes; within 1e-6.  The port rounds the sample coordinate once
after its multiply-add, as XLA compiles the JAX function on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seam_match_rcnn_tpu.ops.masks import paste_masks as jax_paste_masks

from seam_match_rcnn_tpu_torch.ops.masks import paste_masks


def _boxes(rng, kind, n, h, w):
    x1, y1 = rng.uniform(0, w * 0.6, n), rng.uniform(0, h * 0.6, n)
    if kind == "inside":
        bw, bh = rng.uniform(4, w * 0.4, n), rng.uniform(4, h * 0.4, n)
    elif kind == "outside":   # past every edge, and one box wholly off the image
        x1, y1 = rng.uniform(-0.5 * w, 1.1 * w, n), rng.uniform(-0.5 * h, 1.1 * h, n)
        bw, bh = rng.uniform(w * 0.3, w, n), rng.uniform(h * 0.3, h, n)
        x1[0], y1[0] = w + 5.0, h + 5.0
    else:                     # thinner than a pixel, and zero-width/-height
        bw, bh = rng.uniform(0.0, 0.9, n), rng.uniform(2, h * 0.5, n)
        bw[1::2], bh[1::2] = rng.uniform(2, w * 0.5, n)[1::2], rng.uniform(0.0, 0.9, n)[1::2]
        bw[0], bh[2] = 0.0, 0.0
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(37, 53), (120, 160)])
@pytest.mark.parametrize("kind", ["inside", "outside", "thin"])
def test_paste_masks_matches_jax(kind, out_hw):
    rng = np.random.RandomState(len(kind) * 1000 + out_hw[0])
    n = 9
    masks = rng.rand(n, 28, 28).astype(np.float32)
    boxes = _boxes(rng, kind, n, *out_hw)
    want = np.asarray(jax_paste_masks(jnp.asarray(masks), jnp.asarray(boxes), *out_hw))
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), *out_hw)
    assert got.dtype == torch.float32 and got.shape == (n,) + out_hw
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if kind == "inside":
        assert (want > 0).mean() > 0.02   # the boxes really paste something
    if kind == "outside":
        assert not want[0].any()
