"""Kernels K3 (``csrc/nlb.cu``) and K4 (``csrc/pairwise.cu``) of the match head.

Replace ``seam_match_rcnn_tpu/ops/pallas_kernels.py``: ``nlb_aggregate``
(fused non-local block + attention pooling) and ``pairwise_scores`` (the
street x shop match-probability matrix).  Both are full f32.  Each wrapper
runs its plain version for CPU tensors and launches its kernel for CUDA
tensors; the source notes in the ``.cu`` files say what bounds each kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import native
from .pairwise import pairwise_match_scores

NLB_KEYS = ("theta_w", "theta_b", "phi_w", "phi_b", "g_w", "g_b", "wcat",
            "wz_w", "wz_b", "att_w", "att_b")
NLB_MAX_T = 32
NLB_SHAPES = {"theta_w": (256, 128), "theta_b": (128,), "phi_w": (256, 128), "phi_b": (128,),
              "g_w": (256, 128), "g_b": (128,), "wcat": (256,), "wz_w": (128, 256),
              "wz_b": (256,), "att_w": (256,), "att_b": (1,)}
# the weights K3 copies to shared memory 16 bytes at a time
_NLB_STAGED = tuple(NLB_KEYS.index(k) for k in ("theta_w", "phi_w", "g_w", "wz_w"))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype is torch.float32 and t.is_contiguous() else t.to(torch.float32).contiguous()


def nlb_aggregate_plain(seqs: torch.Tensor, mask: torch.Tensor,
                        p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's math as plain ops.  seqs [S, T, C]; mask [S, T]; ``p``
    holds the NLB and attention weights with Dense-kernel layouts ([in,
    out]): theta/phi/g [C, C/2], wcat [C], wz [C/2, C], att_w [C], att_b [1].
    Returns [S, C]."""
    seq = seqs.to(torch.float32)
    m = mask.to(torch.float32)
    inter = p["theta_w"].shape[1]
    theta = seq @ p["theta_w"] + p["theta_b"]
    phi = seq @ p["phi_w"] + p["phi_b"]
    g = seq @ p["g_w"] + p["g_b"]
    a = theta @ p["wcat"][:inter]
    c = phi @ p["wcat"][inter:]
    f = torch.relu(a[:, :, None] + c[:, None, :]) * m[:, None, :]
    count = m.sum(dim=1)
    y = (f / count.clamp(min=1.0)[:, None, None]) @ g
    z = y @ p["wz_w"] + p["wz_b"] + seq
    # the reference skips the NLB for single-frame tracks
    keep = (count > 1.0)[:, None, None] & (m[..., None] > 0)
    z = torch.where(keep, z, seq)
    att = z @ p["att_w"] + p["att_b"]
    att = torch.where(m > 0, att, torch.full_like(att, -1e9))
    e = torch.exp(att - att.amax(dim=1, keepdim=True)) * m
    att = e / e.sum(dim=1, keepdim=True).clamp(min=1e-20)
    return (att[..., None] * z).sum(dim=1)


def nlb_aggregate(seqs: torch.Tensor, mask: torch.Tensor,
                  p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fused TemporalAggregator.aggregate: seqs [S, T, 256], mask [S, T] ->
    [S, 256] f32.  CPU tensors take the plain version; the kernel (a
    cluster of 8 blocks a track) takes C = 256, T <= 32, and seqs and the
    four weight matrices 16-byte aligned."""
    if seqs.device.type == "cpu":
        return nlb_aggregate_plain(seqs, mask, p)
    if not all(k in p for k in NLB_KEYS):
        raise ValueError(f"nlb_aggregate: needs the weights {NLB_KEYS}, got {tuple(p)}")
    ws = [_f32(p[k]) for k in NLB_KEYS]
    seqs32, mask32 = _f32(seqs), mask.to(torch.float32).contiguous()
    dev = seqs.device
    s, t, c = seqs.shape if seqs.dim() == 3 else (0, 0, 0)
    # one expression: a serving request's call is bound by the host
    if not (dev.type == "cuda" and c == 256 and 1 <= t <= NLB_MAX_T
            and tuple(mask.shape) == (s, t) and mask.device == dev
            and all(tuple(w.shape) == NLB_SHAPES[k] and w.device == dev
                    for k, w in zip(NLB_KEYS, ws))
            and all(x.data_ptr() % 16 == 0 for x in [seqs32] + [ws[i] for i in _NLB_STAGED])):
        raise ValueError(
            f"nlb_aggregate: needs seqs [S, T, 256] with 1 <= T <= {NLB_MAX_T} and mask "
            f"[S, T] on one CUDA device, weights of shapes {NLB_SHAPES} there, and seqs and "
            f"the theta, phi, g and W_z kernels 16-byte aligned; got seqs "
            f"{tuple(seqs.shape)} on {dev}, mask {tuple(mask.shape)}, weights "
            f"{ {k: tuple(w.shape) for k, w in zip(NLB_KEYS, ws)} }")
    out = torch.empty((s, c), dtype=torch.float32, device=dev)
    if s:
        with native.device(dev):
            status = native.library().seam_nlb_aggregate(
                native.ptr(seqs32), native.ptr(mask32), *[native.ptr(w) for w in ws],
                native.ptr(out), s, t, native.stream(dev))
        native.check(status, "nlb_aggregate")
        nlb_aggregate.launches += 1
    return out


nlb_aggregate.launches = 0


PAIRWISE_TILES = (16, 64)  # the tile rows K4 is built for
PAIRWISE_SHORT_MAX_Q = 128  # the short tile's last Q


def pairwise_tile_rows(q: int) -> int:
    """The tile rows of K4's launch for Q query rows: the short tile (16 x
    16 outputs a block) for a few queries, so that a request spreads the
    gallery over many blocks, the tall one (64 x 64) as Q grows."""
    return PAIRWISE_TILES[0] if q <= PAIRWISE_SHORT_MAX_Q else PAIRWISE_TILES[1]


PAIRWISE_MAX_Q = 65535 * PAIRWISE_TILES[1]  # grid rows of the tall tile


def pairwise_scores(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """x [Q, C], y [G, C], w [2, C], b [2] -> [Q, G] f32 match probability
    (the math of ``ops.pairwise.pairwise_match_scores``).  CPU tensors take
    the plain version; the kernel takes C a multiple of 4 and x, y, w
    16-byte aligned, and forms v = w1 - w0 and c0 = b1 - b0 itself.  A
    request is launch-bound, so the checks are one expression, and f32
    contiguous inputs cost one launch besides the output's allocation."""
    if x.device.type == "cpu":
        return pairwise_match_scores(x, y, w, b)
    x, y, w, b = _f32(x), _f32(y), _f32(w), _f32(b)
    dev = x.device
    two_d = x.dim() == 2 and y.dim() == 2
    q, c, g = (x.shape[0], x.shape[1], y.shape[0]) if two_d else (0, 0, 0)
    if not (two_d and dev.type == "cuda" and y.shape[1] == c and c > 0 and c % 4 == 0
            and q <= PAIRWISE_MAX_Q and w.shape == (2, c) and b.shape == (2,)
            and y.device == dev and w.device == dev and b.device == dev
            and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        raise ValueError(
            f"pairwise_scores: needs x [Q, C], y [G, C], w [2, C] and b [2] on one CUDA "
            f"device, C a positive multiple of 4, Q <= {PAIRWISE_MAX_Q}, and x, y, w "
            f"16-byte aligned; got x {tuple(x.shape)} on {dev}, y {tuple(y.shape)} on "
            f"{y.device}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty((q, g), dtype=torch.float32, device=dev)
    if q and g:
        with native.device(dev):
            status = native.library().seam_pairwise_scores(
                native.ptr(x), native.ptr(y), native.ptr(w), native.ptr(b), native.ptr(out),
                q, g, c, pairwise_tile_rows(q), native.stream(dev))
        native.check(status, "pairwise_scores")
        pairwise_scores.launches += 1
    return out


pairwise_scores.launches = 0
