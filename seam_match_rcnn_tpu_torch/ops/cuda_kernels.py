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
    [S, 256] f32.  CPU tensors take the plain version; the kernel takes
    C = 256 and T <= 32."""
    if seqs.device.type == "cpu":
        return nlb_aggregate_plain(seqs, mask, p)
    name = "nlb_aggregate"
    req = native.require
    req(seqs.device.type == "cuda", name, f"seqs on {seqs.device}, not cuda")
    req(seqs.dim() == 3 and seqs.shape[2] == 256, name, "seqs must be [S, T, 256]")
    s, t, c = seqs.shape
    req(1 <= t <= NLB_MAX_T, name, f"T = {t} outside [1, {NLB_MAX_T}]")
    req(tuple(mask.shape) == (s, t), name, "mask must be [S, T]")
    shapes = {"theta_w": (c, c // 2), "theta_b": (c // 2,), "phi_w": (c, c // 2),
              "phi_b": (c // 2,), "g_w": (c, c // 2), "g_b": (c // 2,), "wcat": (c,),
              "wz_w": (c // 2, c), "wz_b": (c,), "att_w": (c,), "att_b": (1,)}
    ws = []
    for k in NLB_KEYS:
        w = p[k].to(torch.float32).contiguous()
        req(tuple(w.shape) == shapes[k] and w.device == seqs.device, name,
            f"{k} must be {shapes[k]} on {seqs.device}")
        ws.append(w)
    seqs32 = seqs.to(torch.float32).contiguous()
    mask32 = mask.to(torch.float32).contiguous()
    out = torch.empty((s, c), dtype=torch.float32, device=seqs.device)
    if s:
        with torch.cuda.device(seqs.device):
            status = native.library().seam_nlb_aggregate(
                native.ptr(seqs32), native.ptr(mask32), *[native.ptr(w) for w in ws],
                native.ptr(out), s, t, native.stream(seqs.device))
        native.check(status, name)
        nlb_aggregate.launches += 1
    return out


nlb_aggregate.launches = 0


def pairwise_scores(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """x [Q, C], y [G, C], w [2, C], b [2] -> [Q, G] f32 match probability
    (the math of ``ops.pairwise.pairwise_match_scores``).  CPU tensors take
    the plain version; the kernel takes C a multiple of 16."""
    if x.device.type == "cpu":
        return pairwise_match_scores(x, y, w, b)
    name = "pairwise_scores"
    req = native.require
    req(x.device.type == "cuda", name, f"x on {x.device}, not cuda")
    req(x.dim() == 2 and y.dim() == 2 and x.shape[1] == y.shape[1], name,
        "x and y must be [Q, C] and [G, C]")
    q, c = x.shape
    g = y.shape[0]
    req(c % 16 == 0 and c > 0, name, f"C = {c} must be a positive multiple of 16")
    req(tuple(w.shape) == (2, c) and tuple(b.shape) == (2,), name, "w [2, C], b [2]")
    req(y.device == x.device and w.device == x.device and b.device == x.device, name,
        "all inputs on one device")
    xs = x.to(torch.float32).contiguous()
    ys = y.to(torch.float32).contiguous()
    v = (w[1] - w[0]).to(torch.float32).contiguous()
    c0 = (b[1:] - b[:1]).to(torch.float32).contiguous()
    out = torch.empty((q, g), dtype=torch.float32, device=x.device)
    if q and g:
        with torch.cuda.device(x.device):
            status = native.library().seam_pairwise_scores(
                native.ptr(xs), native.ptr(ys), native.ptr(v), native.ptr(c0),
                native.ptr(out), q, g, c, native.stream(x.device))
        native.check(status, name)
        pairwise_scores.launches += 1
    return out


pairwise_scores.launches = 0
