"""Kernel K9 (``ops/vit_attention.py``): the plain version against softmax
attention over a materialised decomposed bias, window by window, on the CPU;
the kernel against the plain version at the ViTDet-L cell's shapes on the card
(``-m cuda``)."""

import pytest
import torch

from seam_match_rcnn_tpu_torch.ops import vit_attention as va


def _attention_by_window(qkv, rel_h, rel_w, s):
    """Each window and head on its own: gather its tokens from the grid,
    build the [T, T] bias from the two terms, softmax(q k^T / sqrt(d) + bias) v."""
    b, hp, wp, c3 = qkv.shape
    nh = rel_h.shape[1]
    d = c3 // (3 * nh)
    x = qkv.to(torch.float64).view(b, hp, wp, 3, nh, d)
    out = torch.zeros(b, hp, wp, nh, d, dtype=torch.float64)
    ky, kx = torch.meshgrid(torch.arange(s), torch.arange(s), indexing="ij")
    ky, kx = ky.reshape(-1), kx.reshape(-1)
    n = 0
    for i in range(b):
        for wy in range(hp // s):
            for wx in range(wp // s):
                win = x[i, wy * s:(wy + 1) * s, wx * s:(wx + 1) * s].reshape(s * s, 3, nh, d)
                for h in range(nh):
                    q, k, v = win[:, 0, h], win[:, 1, h], win[:, 2, h]
                    bias = (rel_h[n, h].to(torch.float64)[:, ky]
                            + rel_w[n, h].to(torch.float64)[:, kx])
                    p = torch.softmax(q @ k.T / d ** 0.5 + bias, dim=-1)
                    out[i, wy * s:(wy + 1) * s, wx * s:(wx + 1) * s, h] = (p @ v).view(s, s, d)
                n += 1
    return out.reshape(b, hp, wp, nh * d)


@pytest.mark.parametrize("grid,s", [(6, 3), (4, 4)], ids=["windowed", "global"])
def test_plain_version_is_attention_with_the_decomposed_bias(grid, s):
    g = torch.Generator().manual_seed(grid)
    nw = 2 * (grid // s) ** 2
    qkv = torch.randn(2, grid, grid, 3 * 2 * 16, generator=g)
    rel_h = torch.randn(nw, 2, s * s, s, generator=g)
    rel_w = torch.randn(nw, 2, s * s, s, generator=g)
    want = _attention_by_window(qkv, rel_h, rel_w, s)
    got = va.vit_attention(qkv, rel_h, rel_w, s)  # a CPU tensor: the op's plain version
    torch.testing.assert_close(got.to(torch.float64), want, rtol=1e-5, atol=1e-5)
    assert va.vit_attention.launches == 0


def test_refuses_a_gradient_and_a_partial_window():
    qkv = torch.randn(1, 4, 4, 3 * 16, requires_grad=True)
    rel = torch.randn(4, 1, 4, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        va.vit_attention(qkv, rel, rel, 2)
    with pytest.raises(ValueError, match="whole windows"):
        va.vit_attention(qkv.detach()[:, :3, :3], rel, rel, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K9 is a Triton kernel: no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid,s", [(70, 14), (64, 64), (14, 7)],
                         ids=["cell_windowed", "cell_global", "small_window"])
def test_kernel_matches_the_plain_version(card, grid, s):
    """The cell's two calls over a chunk of 11 canvases, and a window of 7
    (a key row of 7 in 16 slots); bf16 rel terms at the cell's shapes, f32
    ones at the small window.  The kernel rounds the softmax weights to bf16
    for the PV product (2^-9 relative each), so an output may differ from the
    f32 plain version by one bf16 ulp plus 2^-8 of the largest |v|."""
    g = torch.Generator(device=card).manual_seed(grid * s)
    b, nh = (11, 16) if grid >= 64 else (3, 4)
    rdt = torch.bfloat16 if grid >= 64 else torch.float32
    nw = b * (grid // s) ** 2
    qkv = torch.randn(b, grid, grid, 3 * nh * 64, generator=g, device=card).to(torch.bfloat16)
    rel_h = torch.randn(nw, nh, s * s, s, generator=g, device=card).to(rdt)
    rel_w = torch.randn(nw, nh, s * s, s, generator=g, device=card).to(rdt)
    n0 = va.vit_attention.launches
    got = va.vit_attention(qkv, rel_h, rel_w, s)
    want = va.vit_attention_plain(qkv, rel_h, rel_w, s)
    torch.cuda.synchronize()
    assert va.vit_attention.launches == n0 + 1
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    vmax = float(qkv.view(b, grid, grid, 3, nh * 64)[:, :, :, 2].float().abs().max())
    err = (got.float() - want).abs()
    assert bool((err <= ulp + 2.0 ** -8 * vmax).all()), float(err.max())
