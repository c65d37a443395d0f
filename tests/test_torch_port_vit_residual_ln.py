"""Kernel K10 (``ops/vit_residual_ln.py``): the op on the CPU against the op
chain ViTDet's blocks ran before it (the add, the f32 LayerNorm, the cast), bit
for bit; the ViTDet backbone's forward against the same chain block by block
and against the plain reference; its LayerNorm counter; the input checks; and
the kernel against the chain on the card (``-m cuda``)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from seam_match_rcnn_tpu_torch.config import ViTConfig
from seam_match_rcnn_tpu_torch.models import vit as V
from seam_match_rcnn_tpu_torch.ops import vit_residual_ln as rl
from seam_match_rcnn_tpu_torch.utils import profiling

import test_torch_port_vit as tv


def _inputs(shape, dtype, branch=True, device="cpu", seed=0):
    """The f32 stream (offset, so the mean is not near 0), a branch in the
    compute dtype, LayerNorm weights 1 + N(0, 0.1) and biases N(0, 0.1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=device) * 2 + 0.5
    br = torch.randn(shape, generator=g, device=device).to(dtype) if branch else None
    w = 1 + 0.1 * torch.randn(c, generator=g, device=device)
    b = 0.1 * torch.randn(c, generator=g, device=device)
    return x, br, w, b


def _chain(x, branch, w, b, eps, dtype):
    """What ``models/vit.py`` ran before K10: ``x + proj(y)``, then
    ``LayerNorm.forward`` (f32 in, f32 out), then ``.to(dtype)``."""
    if branch is not None:
        x = x + branch
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],), w, b, eps)
    return x, y.to(dtype)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("branch", [True, False], ids=["branch", "no_branch"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (1, 5, 3, 40)], ids=["rows21", "rows15"])
def test_cpu_op_is_the_chain_bit_for_bit(shape, dtype, branch):
    x, br, w, b = _inputs(shape, dtype, branch)
    n0 = rl.vit_residual_ln.launches
    got_x, got_y = rl.vit_residual_ln(x, br, w, b, 1e-6, dtype)
    want_x, want_y = _chain(x, br, w, b, 1e-6, dtype)
    assert got_y.dtype == dtype and got_x.dtype == torch.float32
    assert torch.equal(_bits(got_x), _bits(want_x))
    assert torch.equal(_bits(got_y), _bits(want_y))
    if not branch:
        assert got_x is x
    assert rl.vit_residual_ln.launches == n0


def _chain_vit_forward(self, x):
    """``ViT.forward`` as it ran before K10: block by block, each block its
    own ``norm1``, residual adds and ``norm2`` through the op chain."""
    x = self.patch_embed(x)
    x = x + self.abs_pos(x.shape[1], x.shape[2])
    for blk in self.blocks:
        _, h, w, _ = x.shape
        n1, n2 = blk.norm1, blk.norm2
        y = _chain(x, None, n1.weight, n1.bias, n1.eps, n1.dt)[1]
        if blk.window:
            s = blk.window
            y = F.pad(y, (0, 0, 0, -w % s, 0, -h % s))
        else:
            s = blk.attn.side
        y = blk.attn(y, s)[:, :h, :w]
        x, y = _chain(x, blk.attn.proj(y), n2.weight, n2.bias, n2.eps, n2.dt)
        x = x + blk.mlp(y)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_forward_is_the_chain_bit_for_bit(monkeypatch, dtype):
    """The restructured forward (each block handing the next its normed
    input) gives P2-P6 bit-equal to the block-by-block chain, and stays
    within the reference test's tolerances of the plain reference."""
    got, want = tv._pair(getattr(torch, dtype))
    monkeypatch.setattr(V.ViT, "forward", _chain_vit_forward)
    chain, _ = tv._pair(getattr(torch, dtype))
    for g, c, w in zip(got, chain, want):
        assert torch.equal(_bits(g), _bits(c))
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert float((g.float() - w).norm() / w.norm()) < 0.03


def test_counter_reads_two_a_block():
    """``vit.ln.plain`` counts 48 a forward of the 24 blocks on the CPU (a
    narrow ViT of ViT-L's depth and window layout), ``vit.ln.fused`` none."""
    cfg = dataclasses.replace(ViTConfig(), img_size=128, embed_dim=32, num_heads=2,
                              window_size=4, pretrain_img_size=64)
    assert cfg.depth == 24
    model = V.ViTDetBackbone(cfg, torch.bfloat16)
    x = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(1))
    profiling.clear()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("seam.call"):
            model(x)
    counts = [r for r in profiling.records() if isinstance(r, profiling.Count)]
    profiling.clear()
    assert sum(c.n for c in counts if c.name == "vit.ln.plain") == 48
    assert not [c for c in counts if c.name == "vit.ln.fused"]


def test_check_refuses_what_the_kernel_does_not_take():
    x, br, w, b = _inputs((2, 3, 16), torch.bfloat16)
    check = rl._check
    with pytest.raises(ValueError, match="float32 stream"):
        check(x.to(torch.bfloat16), br, w, b, torch.bfloat16)
    with pytest.raises(ValueError, match="branch must be"):
        check(x, br.float(), w, b, torch.bfloat16)
    with pytest.raises(ValueError, match="compute dtype"):
        check(x, None, w, b, torch.float16)
    with pytest.raises(ValueError, match="x's shape"):
        check(x, br[:, :2], w, b, torch.bfloat16)
    with pytest.raises(ValueError, match=r"weight and bias must be \[16\]"):
        check(x, br, w[:8], b, torch.bfloat16)
    with pytest.raises(ValueError, match="weight and bias must be float32"):
        check(x, br, w.to(torch.bfloat16), b, torch.bfloat16)
    with pytest.raises(ValueError, match="x's device"):
        check(x, br.to("meta"), w, b, torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[\.\.\., C\]"):
        check(x[0, 0], None, w, b, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        rl.vit_residual_ln(x, br, w.requires_grad_(), b, 1e-6, torch.bfloat16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K10 is a CUDA kernel: no CPU or interpret mode)")
    return torch.device("cuda")


def _tol(v, dtype):
    """How far the kernel's y may lie from the chain's on the card, whose
    statistics round differently (Welford over its threads): both sides form
    the f32 output to within ~1e-6 of the row's scale, so in bf16 y may cross
    one rounding boundary, one bf16 ulp, taken no finer than at 2^-6 (below it
    y is a cancellation of w * rstd * (x - mean) against the bias, and the f32
    error is larger than the spacing there); in f32 the difference is the
    statistics' few f32 ulps, 2^-19 (1 + |y|)."""
    if dtype == torch.float32:
        return 2.0 ** -19 * (1 + v.abs())
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -6))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,branch", [
    ((11, 64, 64, 1024), torch.bfloat16, True),
    ((11, 64, 64, 1024), torch.bfloat16, False),
    ((3, 37, 1024), torch.bfloat16, True),
    ((5, 13, 520), torch.bfloat16, True),
    ((3, 37, 1024), torch.float32, True),
], ids=["cell", "cell_no_branch", "ragged_rows", "ragged_channels", "f32"])
def test_kernel_matches_the_chain(card, shape, dtype, branch):
    """x_new bit for bit; y within ``_tol`` of the chain on the card (one bf16
    ulp); the share of elements of y that differ is printed."""
    x, br, w, b = _inputs(shape, dtype, branch, card, seed=shape[-1])
    n0 = rl.vit_residual_ln.launches
    got_x, got_y = rl.vit_residual_ln(x, br, w, b, 1e-6, dtype)
    want_x, want_y = _chain(x, br, w, b, 1e-6, dtype)
    torch.cuda.synchronize()
    assert rl.vit_residual_ln.launches == n0 + 1
    assert torch.equal(_bits(got_x), _bits(want_x))
    err = (got_y.float() - want_y.float()).abs()
    bound = _tol(torch.maximum(got_y.float().abs(), want_y.float().abs()), dtype)
    share = float((got_y != want_y).float().mean())
    print(f"K10 {shape} {dtype}: y differs from the chain in {100 * share:.4f}% of elements, "
          f"max |diff| {float(err.max()):.3g}, max |diff| / bound {float((err / bound).max()):.3g}")
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_kernel_propagates_nan_and_inf_as_the_chain(card):
    """A NaN in x, an infinity in the branch and inf - inf each make their
    row's y NaN everywhere in both; x_new holds them bit for bit; the other
    rows are untouched."""
    x, br, w, b = _inputs((4, 9, 1024), torch.bfloat16, True, card)
    x[0, 1, 5] = float("nan")
    br[1, 2, 7] = float("inf")
    x[2, 3, 3], br[2, 3, 3] = float("-inf"), float("inf")
    br[3, 4, 100] = float("-inf")
    got_x, got_y = rl.vit_residual_ln(x, br, w, b, 1e-6, torch.bfloat16)
    want_x, want_y = _chain(x, br, w, b, 1e-6, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got_x), _bits(want_x))
    bad = torch.zeros(x.shape[:-1], dtype=torch.bool, device=card)
    bad[0, 1] = bad[1, 2] = bad[2, 3] = bad[3, 4] = True
    assert torch.equal(want_y.isnan().all(-1), bad) and torch.equal(got_y.isnan(), want_y.isnan())
    err = (got_y[~bad].float() - want_y[~bad].float()).abs()
    assert bool((err <= _tol(want_y[~bad].float(), torch.bfloat16)).all())
