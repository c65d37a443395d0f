"""Kernel K8's op (``ops/cuda_epilogue``) and the backbone that calls it, on the CPU.

The op ``seam::bn_epilogue`` (FrozenBN scale and shift, the residual, ReLU)
runs its plain version on CPU tensors; its backward is the op
``seam::bn_epilogue_backward``.  Held bit for bit against the op chain the
backbone ran before K8 (copied below as ``chain``): every residual kind, ReLU
on and off, bf16 and f32, with NaN, infinities and signed zeros among the
inputs; a ResNet-50's forward and gradients against the same chain; the
scale/shift cache; the ``bn.fused``/``bn.plain`` counters and the benchmark's
``bn_fused_pct`` reader; ``torch.export`` keeping the op.  The tests marked
``cuda`` at the end hold the kernel to the same plain version on the card.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from portbench import run as R
from portbench import spans
from portbench.trace import Op, Trace
from seam_match_rcnn_tpu_torch.models.layers import FrozenBatchNorm2d
from seam_match_rcnn_tpu_torch.models.resnet import ResNet50
from seam_match_rcnn_tpu_torch.ops import cuda_epilogue as ce
from seam_match_rcnn_tpu_torch.parallel import mesh as mesh_mod
from seam_match_rcnn_tpu_torch.utils import profiling
from seam_match_rcnn_tpu_torch.utils.profiling import Count, Span

torch.set_num_threads(2)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(INT[a.dtype]), b.contiguous().view(INT[b.dtype]))


def chain_bn(bn, x):
    """FrozenBatchNorm2d.forward as it was before K8."""
    scale, shift = bn.scale_shift()
    dt = bn.compute_dtype
    return x * scale.to(dt)[None, :, None, None] + shift.to(dt)[None, :, None, None]


def chain_block(blk, x):
    """Bottleneck.forward as it was before K8."""
    out = F.relu(chain_bn(blk.bn1, blk.conv1(x)))
    out = F.relu(chain_bn(blk.bn2, blk.conv2(out)))
    out = chain_bn(blk.bn3, blk.conv3(out))
    idt = x if blk.downsample is None else chain_bn(blk.downsample[1], blk.downsample[0](x))
    return F.relu(out + idt)


def chain_body(m, x):
    """ResNet50.forward (stem_backend="xla") as it was before K8."""
    x = F.max_pool2d(F.relu(chain_bn(m.bn1, m.conv1(x))), 3, stride=2, padding=1)
    outs = []
    for i in range(1, 5):
        for blk in getattr(m, f"layer{i}"):
            x = chain_block(blk, x)
        outs.append(x)
    return tuple(outs)


def _specials(t, g):
    """Plant NaN, +-inf and signed zeros in ``t``."""
    idx = torch.randint(0, t.numel(), (10,), generator=g, device=t.device)
    t.view(-1)[idx] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0] * 2,
                                   dtype=t.dtype, device=t.device)
    return t


def _case(dt, mode, shape=(2, 16, 5, 7), seed=0, device="cpu"):
    """(y, scale, shift, residual, residual scale, residual shift) drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device).to(dt)  # noqa: E731
    rand = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    c = shape[1]
    y = _specials(randn(*shape), g)
    scale, shift = (rand(c) * 2 - 0.5).to(dt), randn(c)  # some scales negative
    scale[0], shift[1] = -0.0, -0.0
    res = sr = hr = None
    if mode != "none":
        res = _specials(randn(*shape), g)
    if mode == "raw":
        sr, hr = (rand(c) + 0.5).to(dt), randn(c)
    return y, scale, shift, res, sr, hr


def chain_epilogue(y, scale, shift, res, sr, hr, relu):
    c = lambda v: v[None, :, None, None]  # noqa: E731
    out = y * c(scale) + c(shift)
    if res is not None:
        out = out + (res if sr is None else res * c(sr) + c(hr))
    return F.relu(out) if relu else out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mode", ["none", "identity", "raw"])
def test_op_and_its_backward_equal_the_chain_bit_for_bit(dtype, relu, mode):
    dt = DTYPES[dtype]
    y, scale, shift, res, sr, hr = _case(dt, mode)
    want = chain_epilogue(y, scale, shift, res, sr, hr, relu)
    got = ce.bn_epilogue(y, scale, shift, res, sr, hr, relu)
    assert bits_equal(got, want)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()

    leaves = [y.clone().requires_grad_()] + ([res.clone().requires_grad_()] if res is not None
                                             else [])
    g = torch.Generator().manual_seed(1)
    cot = _specials(torch.randn(y.shape, generator=g).to(dt), g)
    r_ = leaves[1] if res is not None else None
    want_g = torch.autograd.grad(chain_epilogue(leaves[0], scale, shift, r_, sr, hr, relu),
                                 leaves, cot)
    got_g = torch.autograd.grad(ce.bn_epilogue(leaves[0], scale, shift, r_, sr, hr, relu),
                                leaves, cot)
    for a, b in zip(got_g, want_g):
        assert bits_equal(a, b)


def test_op_takes_non_contiguous_input_and_refuses_a_gradient_of_its_scale():
    y, scale, shift, res, sr, hr = _case(torch.float32, "raw", shape=(2, 8, 6, 4))
    got = ce.bn_epilogue(y.transpose(2, 3), scale, shift, res.transpose(2, 3), sr, hr, True)
    want = chain_epilogue(y.transpose(2, 3), scale, shift, res.transpose(2, 3), sr, hr, True)
    assert got.is_contiguous() and bits_equal(got, want)
    with pytest.raises(RuntimeError, match="no gradient"):
        ce.bn_epilogue(y, scale.requires_grad_(), shift, relu=True)


def _resnet(dt, remat=False, seed=0):
    torch.manual_seed(seed)
    m = ResNet50(dt, "xla", block_counts=(2, 2, 1, 1), remat=remat)
    g = torch.Generator().manual_seed(seed)
    for mod in m.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            n = mod.weight.numel()
            mod.weight.copy_(torch.rand(n, generator=g) + 0.5)
            mod.bias.copy_(torch.randn(n, generator=g) * 0.2)
            mod.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
            mod.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    return m


@pytest.mark.parametrize("dtype,remat", [("bf16", False), ("f32", False), ("bf16", True)])
def test_resnet_forward_and_gradients_equal_the_chain(dtype, remat):
    """Identity and raw-downsample blocks in every stage; the input takes a
    gradient too, so the frozen stem and layer1 run their backward."""
    dt = DTYPES[dtype]
    m = _resnet(dt, remat)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 64, 96, generator=g).requires_grad_()
    cots = None
    results = []
    for body in (chain_body, m):
        outs = body(m, x) if body is chain_body else body(x)
        if cots is None:
            cots = [torch.randn(o.shape, generator=g).to(o.dtype) for o in outs]
        leaves = [x] + [p for p in m.parameters() if p.requires_grad]
        results.append((outs, torch.autograd.grad(outs, leaves, cots)))
    (want, want_g), (got, got_g) = results
    assert len(got_g) > 1
    for a, b in zip(got + got_g, want + want_g):
        assert bits_equal(a, b)


@pytest.mark.parametrize("change", ["load_state_dict", "fill", "to", "replicate", "none"])
def test_scale_shift_cache_refreshes(monkeypatch, change):
    bn = FrozenBatchNorm2d(8, compute_dtype=torch.bfloat16)
    first = bn.compute_scale_shift()
    assert first[0].dtype == torch.bfloat16
    if change == "replicate":  # rank 0's buffers arrive through a broadcast into .data
        monkeypatch.setattr(mesh_mod.dist, "broadcast", lambda t, src: t.fill_(2.0))
        mesh_mod.replicate(bn, types.SimpleNamespace(size=lambda: 2))
    elif change == "load_state_dict":
        sd = {k: v + 0.25 for k, v in bn.state_dict().items()}
        bn.load_state_dict(sd)
    elif change == "fill":
        bn.running_var.fill_(4.0)
    elif change == "to":
        bn.to(torch.float64)
    now = bn.compute_scale_shift()
    scale, shift = bn.scale_shift()
    assert torch.equal(now[0], scale.to(torch.bfloat16))
    assert torch.equal(now[1], shift.to(torch.bfloat16))
    if change == "none":
        assert now[0] is first[0] and now[1] is first[1]  # served from the cache
    else:
        assert not torch.equal(now[0].float(), first[0].float()) or change == "to"
        assert now[0] is not first[0]


def test_scale_shift_cache_is_usable_after_inference_mode():
    m = _resnet(torch.float32)
    x = torch.randn(1, 3, 32, 32)
    with torch.inference_mode():
        m(x)
    outs = m(x.requires_grad_())
    sum(o.sum() for o in outs).backward()  # the cached scales are saved for backward
    assert x.grad is not None


@pytest.mark.parametrize("stem", ["xla", "pallas"])
def test_bn_counters_record_under_a_profiler_only(stem):
    m = ResNet50(torch.float32, stem, block_counts=(1, 1, 1, 1))
    x = torch.randn(1, 3, 32, 32)
    profiling.clear()
    m(x)
    assert profiling.records() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        m(x)
    recs = profiling.records()
    profiling.clear()
    # 3 a bottleneck, 1 a downsample, the stem's unless K1 applies it
    assert recs == [Count("bn.plain", recs[0].t_ns, 12 + 4 + (stem == "xla"), None,
                          recs[0].thread)]


MS = 1_000_000


@pytest.mark.parametrize("counts,want", [
    ([("bn.fused", 52), ("bn.fused", 52)], 100.0),
    ([("bn.fused", 52), ("bn.plain", 52), ("bn.fused", 52), ("bn.plain", 52)], 50.0),
    ([("bn.plain", 53)], 0.0),
    ([], None)])
def test_bn_fused_pct_reads_the_device_phase(monkeypatch, counts, want):
    """The reader sums the counters of the device phase alone: an earlier
    run's and the host phase's counts are left out; a program that counts
    neither reads None."""
    recs = [Count("bn.plain", -50 * MS, 52, 1, 1),  # before the phase
            Count("bn.plain", 250 * MS, 52, 9, 1)]  # the host phase
    recs += [Count(n, (10 + i) * MS, k, 2, 1) for i, (n, k) in enumerate(counts)]
    recs.append(Span("seam.call", 0, 100 * MS, None, 2, 1))
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    trace = Trace([Op("kernel", 10 * MS, 90 * MS, [], [], [], 0)], 0.1, 4, [], [],
                  (200 * MS, 300 * MS))
    for kind in ("index", "train"):
        got = R.reader(f"bn_fused_pct.{kind}").read(trace, None)
        assert got == (None if want is None else pytest.approx(want))


def test_export_keeps_the_op_and_replays_bit_equal():
    m = _resnet(torch.bfloat16)
    x = torch.randn(1, 3, 64, 64)
    program = torch.export.export(m, (x,), strict=False)
    ops = [n for n in program.graph.nodes if n.op == "call_function"
           and str(n.target) == "seam.bn_epilogue.default"]
    # one op a conv of the body and the stem; a downsample's FrozenBN rides on its block's conv3
    assert len(ops) == 3 * 6 + 1 and m.n_bn == len(ops) + 4
    with torch.no_grad():
        got, want = program.module()(x), m(x)
    for a, b in zip(got, want):
        assert bits_equal(a, b)


# ---- on the card (``-m cuda``): the kernel against the plain chain, bit for bit ----------
#
#     python -m pytest --noconftest -q -m cuda tests/test_torch_port_bn_epilogue.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K8 has no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def body_epilogues(h, w):
    """(C, H, W, residual kind) of each distinct K8 call of the body on an
    h x w canvas (the stem's output is h/4 x w/4); every call has ReLU."""
    hh, ww, planes, out = h // 4, w // 4, 64, []
    for stage, n in enumerate((3, 4, 6, 3)):
        for blk in range(n):
            out.append((planes, hh, ww, "none"))  # conv1, at the block's input size
            if stage > 0 and blk == 0:  # the 3x3's stride 2, padding 1
                hh, ww = (hh + 1) // 2, (ww + 1) // 2
            out += [(planes, hh, ww, "none"), (planes * 4, hh, ww, "raw" if blk == 0
                                                else "identity")]
        planes *= 2
    return list(dict.fromkeys(out))


def _check_on_card(args, relu, grad_seed):
    """K8's forward and backward, through the eager path and through the
    custom op (its registered autograd), against the plain chain's on the
    same card."""
    y, scale, shift, res, sr, hr = args
    n0, g0 = ce.bn_epilogue.launches, ce.bn_epilogue_grad.launches
    g = torch.Generator(device=y.device).manual_seed(grad_seed)
    cot = torch.randn(y.shape, generator=g, device=y.device).to(y.dtype)
    cot.view(-1)[:7] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                                     1.0, -1.0], device=y.device, dtype=y.dtype)
    results = []
    for fn in (ce.bn_epilogue, torch.ops.seam.bn_epilogue, ce.bn_epilogue_plain):
        leaves = [y.clone().requires_grad_()] + ([res.clone().requires_grad_()]
                                                 if res is not None else [])
        out = fn(leaves[0], scale, shift, leaves[1] if res is not None else None, sr, hr, relu)
        results.append((out,) + torch.autograd.grad(out, leaves, cot))
    for got in results[:2]:
        for a, b in zip(got, results[2]):
            assert bits_equal(a, b)
    torch.cuda.synchronize()
    assert ce.bn_epilogue.launches == n0 + 2 and ce.bn_epilogue_grad.launches == g0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,w", [(11, 800, 1344), (3, 800, 1344), (5, 1344, 800)])
def test_kernel_equals_the_chain_at_the_body_shapes(card, dtype, b, h, w):
    """Every distinct call of a batch-11 serving forward and of the training
    buckets' (odd batches, both orientations; layer4's 25 x 42 plane is no
    multiple of the vector), NaN, infinities and signed zeros planted."""
    for i, (c, hh, ww, mode) in enumerate(body_epilogues(h, w)):
        _check_on_card(list(_case(DTYPES[dtype], mode, (b, c, hh, ww), i, card)), True, i)
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mode", ["none", "identity", "raw"])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last", "unaligned"])
def test_kernel_equals_the_chain_on_ragged_planes_and_layouts(card, dtype, relu, mode, layout):
    """Planes of 35 values (vectors straddle two or three channels), an odd
    batch and a ragged tail; channels_last input is made contiguous; input
    that starts off a 16-byte boundary takes the kernel's value-by-value
    path."""
    args = list(_case(DTYPES[dtype], mode, (3, 24, 5, 7), 7, card))
    for i in (0, 3):  # y and the residual
        t = args[i]
        if t is None:
            continue
        if layout == "channels_last":
            args[i] = t.contiguous(memory_format=torch.channels_last)
        elif layout == "unaligned":
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            args[i] = buf[1:].view(t.shape).copy_(t)
            assert args[i].data_ptr() % 16 != 0
    _check_on_card(args, relu, 11)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_resnet_on_the_card_equals_the_chain(card, remat):
    """A bf16 ResNet-50 (two blocks in layer1 and layer2) on the card: K8's
    forward and gradients against the chain's, with cuDNN's deterministic
    algorithms so that both sides' convs agree bit for bit."""
    m = _resnet(torch.bfloat16, remat).to(card)
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(3, 3, 224, 320, generator=g, device=card).requires_grad_()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results, cots = [], None
        for body in (chain_body, m):
            n0 = ce.bn_epilogue.launches
            outs = body(m, x) if body is chain_body else body(x)
            assert ce.bn_epilogue.launches - n0 == (0 if body is chain_body else 19)
            if cots is None:
                cots = [torch.randn(o.shape, generator=g, device=card).to(o.dtype) for o in outs]
            leaves = [x] + [p for p in m.parameters() if p.requires_grad]
            results.append((outs, torch.autograd.grad(outs, leaves, cots)))
    finally:
        torch.backends.cudnn.deterministic = prev
    (want, want_g), (got, got_g) = results
    for a, b in zip(got + got_g, want + want_g):
        assert bits_equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    y, scale, shift, res, sr, hr = _case(torch.bfloat16, "raw", (2, 8, 4, 4), 0, card)
    with pytest.raises(ValueError, match="dtype"):
        ce.bn_epilogue(y.half(), scale.half(), shift.half())
    with pytest.raises(ValueError, match="device"):
        ce.bn_epilogue(y, scale.cpu(), shift)
    with pytest.raises(ValueError, match="scale must be"):
        ce.bn_epilogue(y, scale[:4], shift)
    with pytest.raises(ValueError, match="residual must have"):
        ce.bn_epilogue(y, scale, shift, res[:1])
    with pytest.raises(ValueError, match="shift_r"):
        ce.bn_epilogue(y, scale, shift, res, sr, None)
