"""A plain float32 ViTDet backbone: the trunk and the simple feature pyramid.

Written from Li, Mao, Girshick and He, *Exploring Plain Vision Transformer
Backbones for Object Detection* (arXiv:2203.16527) and the detectron2 config
it is published with (``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py``
on ``configs/common/models/mask_rcnn_vitdet.py``), in plain ``torch`` with no
kernel, no cache and no batching tricks; it imports neither JAX nor the port.
Parameter names are detectron2's (``net.blocks.{i}.attn.qkv.weight``,
``simfp_2.4.norm.weight``, ...), so the port's backbone state dict loads here.

Departures from detectron2, each with no effect on the forward:
* ``get_rel_pos`` never resizes a table: every table here is built for its
  block's window or grid (2S - 1 rows), as in ViTDet-L at its own canvas.
* Drop-path (training only) and activation checkpointing are left out.
* Attention is computed a few heads at a time, so a global block's [T, T]
  logits fit beside a large model.

The caller sets TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) before running it on a card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

ATTN_CHUNK_ELEMENTS = 1 << 26  # logits computed at once: 256 MB in float32


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The [size, size, C] table of each (query, key) pair of one axis:
    rel_pos[q - k + size - 1]."""
    coords = torch.arange(size, device=rel_pos.device)
    return rel_pos[coords[:, None] - coords[None, :] + (size - 1)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, hw):
    """attn [n, T, T] + rel_h[q, k_h] + rel_w[q, k_w], rel_h = q . Rh with the
    unscaled q [n, T, C]."""
    h, w = hw
    rh, rw = get_rel_pos(h, rel_pos_h), get_rel_pos(w, rel_pos_w)
    n, _, dim = q.shape
    r_q = q.reshape(n, h, w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.view(n, h, w, h, w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.view(n, h * w, h * w)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.num_heads, h * w, -1).unbind(0)
        step = max(1, ATTN_CHUNK_ELEMENTS // (h * w) ** 2)
        out = []
        for i in range(0, q.shape[0], step):
            j = slice(i, i + step)
            attn = (q[j] * self.scale) @ k[j].transpose(-2, -1)
            attn = add_decomposed_rel_pos(attn, q[j], self.rel_pos_h, self.rel_pos_w, (h, w))
            out.append(attn.softmax(dim=-1) @ v[j])
        x = torch.cat(out).view(b, self.num_heads, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(b, h, w, -1))


def window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> windows [B * nW, ws, ws, C], zero-padded, and the
    padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, window_size, input_size, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qkv_bias,
                              window_size if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


def get_abs_pos(abs_pos: torch.Tensor, has_cls_token: bool, hw) -> torch.Tensor:
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    if size != h or size != w:
        new = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
                            size=(h, w), mode="bicubic", align_corners=False)
        return new.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


class ViT(nn.Module):
    def __init__(self, img_size=1024, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
                 mlp_ratio=4.0, qkv_bias=True, window_size=14,
                 window_block_indexes: Sequence[int] = (), pretrain_img_size=224,
                 pretrain_use_cls_token=True, eps=1e-6):
        super().__init__()
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n = (pretrain_img_size // patch_size) ** 2 + int(pretrain_use_cls_token)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                  window_size if i in window_block_indexes else 0, img_size // patch_size, eps)
            for i in range(depth))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, self.pretrain_use_cls_token, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class LayerNorm(nn.Module):
    """detectron2's channel LayerNorm of an NCHW map."""

    def __init__(self, n: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class NormConv2d(nn.Conv2d):
    def __init__(self, cin, cout, k, eps):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = LayerNorm(cout, eps)

    def forward(self, x):
        return self.norm(super().forward(x))


class ViTDetBackbone(nn.Module):
    """``SimpleFeaturePyramid(net=ViT(...), in_feature="last_feat",
    out_channels=256, scale_factors=(4.0, 2.0, 1.0, 0.5),
    top_block=LastLevelMaxPool(), norm="LN")`` -> (p2, ..., p6)."""

    def __init__(self, cfg):
        super().__init__()
        self.net = ViT(cfg.img_size, cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads,
                       cfg.mlp_ratio, cfg.qkv_bias, cfg.window_size,
                       tuple(cfg.window_block_indexes), cfg.pretrain_img_size,
                       cfg.pretrain_use_cls_token, cfg.ln_eps)
        dim, out, eps = cfg.embed_dim, cfg.out_channels, cfg.ln_eps
        self.names = []
        for scale in cfg.scale_factors:
            out_dim = dim
            if scale == 4.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2), LayerNorm(dim // 2, eps),
                          nn.GELU(), nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)]
                out_dim = dim // 4
            elif scale == 2.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)]
                out_dim = dim // 2
            elif scale == 1.0:
                layers = []
            else:
                layers = [nn.MaxPool2d(2, 2)]
            layers += [NormConv2d(out_dim, out, 1, eps), NormConv2d(out, out, 3, eps)]
            name = f"simfp_{int(math.log2(cfg.patch_size / scale))}"
            self.add_module(name, nn.Sequential(*layers))
            self.names.append(name)

    def forward(self, x):
        top = self.net(x)
        feats = [getattr(self, n)(top) for n in self.names]
        return tuple(feats) + (F.max_pool2d(feats[-1], kernel_size=1, stride=2, padding=0),)
