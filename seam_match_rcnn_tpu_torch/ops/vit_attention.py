"""Kernel K9: ViTDet's attention with decomposed relative positions, one launch
a call (a Triton kernel, built at its first launch).

For each window of ``window`` x ``window`` tokens of a padded token grid (a
global block is one window over the whole grid) and each head::

    logits = (q * d^-0.5) @ k^T + rel_h[q, k_row] + rel_w[q, k_col]
    out    = softmax(logits) @ v

where ``rel_h`` / ``rel_w`` [B*nW, heads, T, S] (T = S * S tokens a window) are
ViTDet's ``add_decomposed_rel_pos`` terms, the unscaled q against the gathered
position tables, formed outside by ``torch.matmul``.  The padded tokens of a
windowed block are real keys (detectron2 does not mask them).

Layouts: ``qkv`` [B, Hp, Wp, 3 * heads * d] is the ``qkv`` projection of the
padded grid as it comes out of the dense layer (channels ``(3, heads, d)``);
the kernel reads each window's q, k and v from it in place, so no window
partition is copied, and writes ``out`` [B, Hp, Wp, heads * d] in the layout
the output projection takes.  Windows are ordered (b, row, column).

It replaces no TPU kernel: the JAX package has no vision transformer.  What
bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a global block at 64 x 64
tokens is bound by its operations (2 x 2 x 4096^2 x 64 a head), a windowed
block at 196 tokens by its bytes (q, k, v and out, 8 KB a token-head of work
against 4 MFLOP a window-head).  The design: a flash-attention loop in f32
(online softmax in base 2, bf16 products on the tensor cores with f32 sums),
so the [T, T] logits and the bias never reach device memory (a materialised
bias alone would be 5.9 GB in bf16 for a global block of 11 images).  Key
blocks are two whole key rows of the window (2 x 64 keys in a global block,
2 x 14 padded to 16 in a windowed one), so a block's ``rel_w`` columns are
the same in every block and its ``rel_h`` term is one value a query and key
row; where the rows and windows come out whole (the global block) no load
is masked.  Block sizes from a sweep on the card.

The op is ``seam::vit_attention``: its CPU implementation is the plain
version, its CUDA implementation the launch (which counts
``vit_attention.launches``), and its fake implementation gives the output's
shape.  Forward only: ViTDet training is not ported.
"""

from __future__ import annotations

import torch

from . import native

LOG2E = 1.4426950408889634
_PLAIN_CHUNK_BYTES = 1 << 30  # the plain version's logits a chunk of windows


def _geometry(qkv: torch.Tensor, rel_h: torch.Tensor, window: int):
    b, hp, wp, c3 = qkv.shape
    heads = rel_h.shape[1]
    return b, hp, wp, heads, c3 // (3 * heads), hp // window, wp // window


def vit_attention_plain(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                        window: int) -> torch.Tensor:
    """The kernel's function as plain ops, in float32 from the bf16 inputs
    (the [T, T] bias materialised), rounded to the output's bf16; chunked
    over the windows so the logits of a chunk stay near 1 GB."""
    b, hp, wp, nh, d, ny, nx = _geometry(qkv, rel_h, window)
    s, t = window, window * window
    x = qkv.view(b, ny, s, nx, s, 3, nh, d).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = x.reshape(3, b * ny * nx, nh, t, d).to(torch.float32).unbind(0)
    rh, rw = rel_h.to(torch.float32), rel_w.to(torch.float32)
    step = max(1, _PLAIN_CHUNK_BYTES // (nh * t * t * 4))
    outs = []
    for i in range(0, q.shape[0], step):
        j = slice(i, i + step)
        logits = q[j] @ k[j].transpose(-1, -2) * d ** -0.5
        bias = rh[j][..., :, None] + rw[j][..., None, :]  # [n, heads, T, S rows, S cols]
        p = torch.softmax(logits + bias.reshape(logits.shape), dim=-1)
        outs.append(p @ v[j])
    o = torch.cat(outs).view(b, ny, nx, nh, s, s, d).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, hp, wp, nh * d).to(qkv.dtype)


def _check(qkv, rel_h, rel_w, window: int) -> None:
    name = "vit_attention"
    req = native.require
    req(qkv.dim() == 4 and rel_h.dim() == 4, name,
        f"qkv must be [B, Hp, Wp, 3*heads*d] and rel_h [B*nW, heads, T, S], got "
        f"{tuple(qkv.shape)} and {tuple(rel_h.shape)}")
    b, hp, wp, nh, d, ny, nx = _geometry(qkv, rel_h, window)
    s = window
    req(window > 0 and hp % s == 0 and wp % s == 0, name,
        f"the grid {hp}x{wp} must be whole windows of {s}")
    req(qkv.shape[-1] == 3 * nh * d, name, f"qkv's channels {qkv.shape[-1]} are not 3 x "
        f"{nh} heads x d")
    want = (b * ny * nx, nh, s * s, s)
    req(tuple(rel_h.shape) == want and tuple(rel_w.shape) == want, name,
        f"rel_h and rel_w must be {want}, got {tuple(rel_h.shape)}, {tuple(rel_w.shape)}")


@torch.library.custom_op("seam::vit_attention", mutates_args=(), device_types="cpu")
def _attention_op(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                  window: int) -> torch.Tensor:
    """``seam::vit_attention`` on CPU tensors: the plain version."""
    _check(qkv, rel_h, rel_w, window)
    return vit_attention_plain(qkv, rel_h, rel_w, window)


# Key rows a block, query rows a block, warps, stages: from a sweep of each on
# the H100 at the ViTDet-L cell's two calls (windows of 14, the global 64).
KEY_ROWS, BLOCK_M, WARPS, STAGES = 2, 128, 8, 3


_kernel = None


def _build():
    """The Triton kernel, defined at its first launch (``triton`` is imported
    only here: the CPU tests import this module without it)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def vit_attention_kernel(QKV, RH, RW, O, scale_log2, HP, WP, NX, NWIN,
                             S: tl.constexpr, NH: tl.constexpr, D: tl.constexpr,
                             SP: tl.constexpr, R: tl.constexpr, BLOCK_M: tl.constexpr,
                             N_KB: tl.constexpr, EVEN_M: tl.constexpr, EVEN_N: tl.constexpr):
        T: tl.constexpr = S * S
        BLOCK_N: tl.constexpr = R * SP
        pid_bh = tl.program_id(0)
        pid_m = tl.program_id(1)
        h = pid_bh % NH
        bw = pid_bh // NH
        b = (bw // NWIN).to(tl.int64)
        w = bw % NWIN
        oy = (w // NX) * S
        ox = (w % NX) * S
        c3 = 3 * NH * D
        img = QKV + b * HP * WP * c3 + h * D
        offs_d = tl.arange(0, D)

        offs_m = pid_m * BLOCK_M + tl.arange(0, BLOCK_M)
        m_ok = offs_m < T
        q_row = (oy + offs_m // S) * WP + ox + offs_m % S
        if EVEN_M:
            q = tl.load(img + q_row[:, None] * c3 + offs_d[None, :])
        else:
            q = tl.load(img + q_row[:, None] * c3 + offs_d[None, :], mask=m_ok[:, None],
                        other=0.0)

        # key slot n of a block: key row kb * R + n // SP, column n % SP
        offs_n = tl.arange(0, BLOCK_N)
        kw = offs_n % SP
        kr = offs_n // SP
        rel = (bw.to(tl.int64) * NH + h) * T * S + offs_m * S  # [BLOCK_M] row starts
        rw_ok = m_ok[:, None] & (kw < S)[None, :]

        m_i = tl.full([BLOCK_M], float("-inf"), tl.float32)
        l_i = tl.zeros([BLOCK_M], tl.float32)
        acc = tl.zeros([BLOCK_M, D], tl.float32)
        for kb in range(N_KB):
            kh = kb * R + kr
            n_ok = (kh < S) & (kw < S)
            k_ptr = img + NH * D + ((oy + kh) * WP + ox + kw)[:, None] * c3 + offs_d[None, :]
            if EVEN_N:
                k = tl.load(k_ptr)
                v = tl.load(k_ptr + NH * D)
            else:
                k = tl.load(k_ptr, mask=n_ok[:, None], other=0.0)
                v = tl.load(k_ptr + NH * D, mask=n_ok[:, None], other=0.0)
            # rel_w: the same columns in every block; rel_h: one value a key row
            if EVEN_M and EVEN_N:
                bias = tl.load(RW + rel[:, None] + kw[None, :]).to(tl.float32)
            else:
                bias = tl.load(RW + rel[:, None] + kw[None, :], mask=rw_ok,
                               other=0.0).to(tl.float32)
            for r in tl.static_range(R):
                if EVEN_M and EVEN_N:
                    rh = tl.load(RH + rel + (kb * R + r)).to(tl.float32)
                else:
                    rh = tl.load(RH + rel + (kb * R + r), mask=m_ok & (kb * R + r < S),
                                 other=0.0).to(tl.float32)
                if R == 1:
                    bias = bias + rh[:, None]
                else:
                    bias = bias + tl.where((kr == r)[None, :], rh[:, None], 0.0)
            s = tl.dot(q, tl.trans(k)) * scale_log2 + bias * 1.4426950408889634
            if not EVEN_N:
                s = tl.where(n_ok[None, :], s, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            p = tl.exp2(s - m_new[:, None])
            alpha = tl.exp2(m_i - m_new)
            l_i = l_i * alpha + tl.sum(p, 1)
            acc = acc * alpha[:, None] + tl.dot(p.to(v.dtype), v)
            m_i = m_new
        out = (acc / l_i[:, None]).to(O.dtype.element_ty)
        o_ptr = O + b * HP * WP * NH * D + h * D + q_row[:, None] * (NH * D) + offs_d[None, :]
        if EVEN_M:
            tl.store(o_ptr, out)
        else:
            tl.store(o_ptr, out, mask=m_ok[:, None])

    _kernel = vit_attention_kernel
    return _kernel


@_attention_op.register_kernel("cuda")
def _attention_cuda(qkv, rel_h, rel_w, window):
    """``seam::vit_attention`` on CUDA tensors: the kernel's launch."""
    name = "vit_attention"
    _check(qkv, rel_h, rel_w, window)
    native.require(qkv.dtype == torch.bfloat16, name, f"qkv must be bfloat16, got {qkv.dtype}")
    native.require(rel_h.dtype in (torch.bfloat16, torch.float32) and rel_w.dtype == rel_h.dtype,
                   name, f"rel_h / rel_w dtypes {rel_h.dtype} / {rel_w.dtype}")
    b, hp, wp, nh, d, ny, nx = _geometry(qkv, rel_h, window)
    native.require(d in (16, 32, 64, 128), name, f"head size {d} (16, 32, 64 or 128)")
    native.require(rel_h.device == qkv.device and rel_w.device == qkv.device, name,
                   "rel_h and rel_w must be on qkv's device")
    qkv, rel_h, rel_w = qkv.contiguous(), rel_h.contiguous(), rel_w.contiguous()
    out = torch.empty((b, hp, wp, nh * d), dtype=qkv.dtype, device=qkv.device)
    t = window * window
    sp = max(16, 1 << (window - 1).bit_length())  # a key row's slots: a power of two
    with native.device(qkv.device):
        _build()[(b * ny * nx * nh, -(-t // BLOCK_M))](
            qkv, rel_h, rel_w, out, d ** -0.5 * LOG2E, hp, wp, nx, ny * nx,
            S=window, NH=nh, D=d, SP=sp, R=KEY_ROWS, BLOCK_M=BLOCK_M,
            N_KB=-(-window // KEY_ROWS), EVEN_M=t % BLOCK_M == 0,
            EVEN_N=sp == window and window % KEY_ROWS == 0, num_warps=WARPS, num_stages=STAGES)
    vit_attention.launches += 1
    return out


@_attention_op.register_fake
def _attention_fake(qkv, rel_h, rel_w, window):
    b, hp, wp, c3 = qkv.shape
    return qkv.new_empty((b, hp, wp, c3 // 3))


def vit_attention(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                  window: int) -> torch.Tensor:
    """qkv [B, Hp, Wp, 3 * heads * d] bf16, rel_h / rel_w [B * nW, heads, S * S,
    S] -> [B, Hp, Wp, heads * d] bf16, the attention of every ``window`` x
    ``window`` window (module docstring).  CPU tensors take the plain version,
    CUDA tensors the kernel.  Forward only: raises when an input needs a
    gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qkv, rel_h, rel_w)):
        raise RuntimeError("vit_attention has no backward: ViTDet runs for inference only")
    return torch.ops.seam.vit_attention(qkv, rel_h, rel_w, window)


vit_attention.launches = 0
