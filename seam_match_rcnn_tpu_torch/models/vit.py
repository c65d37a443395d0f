"""ViTDet-L: a plain vision transformer and its simple feature pyramid as the
detector's backbone (``ModelConfig.backbone = "vitdet_l"``).

Li, Mao, Girshick and He, *Exploring Plain Vision Transformer Backbones for
Object Detection* (arXiv:2203.16527), as detectron2 configures it
(``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py``); the parameter
names are detectron2's, under ``backbone.``: ``net.patch_embed.proj``,
``net.pos_embed``, ``net.blocks.{i}.{norm1, attn.qkv, attn.proj,
attn.rel_pos_h, attn.rel_pos_w, norm2, mlp.fc1, mlp.fc2}``, ``simfp_{2..5}.*``.

* Patch embedding: a 16 x 16 stride-16 conv to 1024 channels; the absolute
  position table (pretrained at 224 with a cls token) without its cls row,
  bicubic-interpolated to the grid, added.
* 24 blocks ``x + attn(LN(x))``, ``x + mlp(LN(x))``.  Windowed blocks pad the
  normed grid with zeros to whole 14 x 14 windows; the padded tokens are keys
  like any other (detectron2 masks none).  Global blocks attend over the
  whole grid.  Attention adds the decomposed relative positions: the
  unscaled q against the gathered [2S-1, 64] tables (``rel_terms``), inside
  kernel K9 (``ops/vit_attention.py``) on the card.
* The pyramid from the last map: ConvTranspose x2 (LN, GELU) x2 / x2 /
  identity / max-pool, each then a 1 x 1 and a 3 x 3 conv with channel
  LayerNorm; P6 a stride-2 max-pool of P5 (``LastLevelMaxPool``).

Precision, as ViTDet's mixed-precision inference: parameters f32, dense
layers and convs on bf16 inputs with f32 sums, LayerNorm in f32, the residual
stream f32.  The windowed blocks crop the padded tokens before the output
projection, which acts on each token alone.  Inference only: the attention
kernel has no backward.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ViTConfig
from ..ops.vit_attention import vit_attention
from ..utils.profiling import annotate, count
from .layers import Conv2d, ConvTranspose2d, Linear


def rel_terms(qkv: torch.Tensor, table_h: torch.Tensor, table_w: torch.Tensor,
              window: int, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ViTDet's decomposed relative-position terms of every window of the
    [B, Hp, Wp, 3 * heads * d] ``qkv`` grid: rel_h[n, h, (y, x), ky] = q[y, x] .
    table_h[y - ky + S - 1], rel_w likewise over the columns, with q unscaled
    -> two [B * nW, heads, S * S, S] tensors in qkv's dtype (windows in (b,
    row, column) order)."""
    b, hp, wp, c3 = qkv.shape
    s, d = window, c3 // (3 * heads)
    q = qkv.view(b, hp // s, s, wp // s, s, 3, heads, d)[:, :, :, :, :, 0]
    idx = torch.arange(s, device=qkv.device)
    rel = idx[:, None] - idx[None, :] + (s - 1)
    n = b * (hp // s) * (wp // s)
    rh = torch.einsum("bYyXxhc,ykc->bYXhyxk", q, table_h.to(qkv.dtype)[rel])
    rw = torch.einsum("bYyXxhc,xkc->bYXhyxk", q, table_w.to(qkv.dtype)[rel])
    return rh.reshape(n, heads, s * s, s), rw.reshape(n, heads, s * s, s)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, computed in f32 (ViTDet's ``nn.LayerNorm``
    under autocast)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias,
                            self.eps)


class ChannelLayerNorm(nn.Module):
    """detectron2's ``LayerNorm`` of an NCHW map over its channels, in f32."""

    def __init__(self, n: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1).to(torch.float32), (x.shape[1],), self.weight,
                         self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class NormConv2d(Conv2d):
    """detectron2's ``Conv2d`` with a ``norm``: conv (no bias), then the norm."""

    def __init__(self, cin: int, cout: int, k: int, eps: float, dt: torch.dtype):
        super().__init__(cin, cout, k, padding=k // 2, bias=False, compute_dtype=dt)
        self.norm = ChannelLayerNorm(cout, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, side: int, dt: torch.dtype):
        super().__init__()
        self.heads, self.side = heads, side
        self.qkv = Linear(dim, dim * 3, compute_dtype=dt)
        self.proj = Linear(dim, dim, compute_dtype=dt)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, dim // heads))

    def forward(self, x: torch.Tensor, window: int) -> torch.Tensor:
        """x [B, Hp, Wp, C] (whole windows of ``window``) -> the attention's
        output before ``proj``, [B, Hp, Wp, C] in the compute dtype."""
        qkv = self.qkv(x)
        rel_h, rel_w = rel_terms(qkv, self.rel_pos_h, self.rel_pos_w, window, self.heads)
        return vit_attention(qkv, rel_h, rel_w, window)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dt: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=dt)
        self.fc2 = Linear(hidden, dim, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, window: int, side: int, dt: torch.dtype):
        super().__init__()
        dim = cfg.embed_dim
        self.window = window  # 0: global
        self.dt = dt
        self.norm1 = LayerNorm(dim, eps=cfg.ln_eps)
        self.attn = Attention(dim, cfg.num_heads, window or side, dt)
        self.norm2 = LayerNorm(dim, eps=cfg.ln_eps)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] f32 -> the same."""
        _, h, w, _ = x.shape
        y = self.norm1(x).to(self.dt)
        if self.window:
            s = self.window
            y = F.pad(y, (0, 0, 0, -w % s, 0, -h % s))
        else:
            s = self.attn.side
            if (h, w) != (s, s):
                raise ValueError(f"a global block takes the {s}x{s} grid of its position "
                                 f"tables, got {h}x{w}")
        y = self.attn(y, s)[:, :h, :w]
        # f32 + bf16 -> f32 in one pass (the residual stream stays f32)
        x = x + self.attn.proj(y)
        return x + self.mlp(self.norm2(x).to(self.dt))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dt: torch.dtype):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """-> [B, H/16, W/16, C] contiguous: the token grid every block reads."""
        return self.proj(x).permute(0, 2, 3, 1).contiguous()


class ViT(nn.Module):
    """The trunk: [B, 3, H, W] normalized images -> [B, H/16, W/16, 1024] f32."""

    def __init__(self, cfg: ViTConfig, dt: torch.dtype):
        super().__init__()
        if not (cfg.qkv_bias and cfg.use_rel_pos):
            raise ValueError("the port runs ViTDet's attention as published: qkv_bias and "
                             "use_rel_pos must be True")
        self.cfg = cfg
        side = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim, dt)
        n_pos = (cfg.pretrain_img_size // cfg.patch_size) ** 2 + int(cfg.pretrain_use_cls_token)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, cfg.embed_dim))
        windowed = set(cfg.window_block_indexes)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.window_size if i in windowed else 0, side, dt)
            for i in range(cfg.depth))
        self._pos_cache = None

    def abs_pos(self, h: int, w: int) -> torch.Tensor:
        """detectron2's ``get_abs_pos``: the table without its cls row,
        bicubic-interpolated to h x w -> [1, h, w, C] f32, cached on the
        parameter's storage and version (a load or an in-place fill refreshes
        it)."""
        p = self.pos_embed
        key = (h, w, p.device, p.data_ptr(), p._version)
        if torch.compiler.is_compiling() or self._pos_cache is None or self._pos_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                table = p[:, 1:] if self.cfg.pretrain_use_cls_token else p
                size = int(math.sqrt(table.shape[1]))
                grid = table.reshape(1, size, size, -1).permute(0, 3, 1, 2)
                if (size, size) != (h, w):
                    grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                                         align_corners=False)
                self._pos_cache = (key, grid.permute(0, 2, 3, 1).contiguous(), p.detach())
        return self._pos_cache[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.abs_pos(x.shape[1], x.shape[2])  # bf16 + f32 -> the f32 stream
        for blk in self.blocks:
            x = blk(x)
        return x


class ViTDetBackbone(nn.Module):
    """ViT and simple feature pyramid: [B, 3, H, W] normalized images (H, W
    multiples of 64) -> (P2, ..., P6), ``out_channels`` each, in the compute
    dtype, strides 4 to 64 (the FPN's interface)."""

    def __init__(self, cfg: ViTConfig, dt: torch.dtype):
        super().__init__()
        self.cfg, self.dt = cfg, dt
        self.net = ViT(cfg, dt)
        dim, out, eps = cfg.embed_dim, cfg.out_channels, cfg.ln_eps
        self.stages = []
        for scale in cfg.scale_factors:
            if scale == 4.0:
                layers = [ConvTranspose2d(dim, dim // 2, 2, stride=2, compute_dtype=dt),
                          ChannelLayerNorm(dim // 2, eps), nn.GELU(),
                          ConvTranspose2d(dim // 2, dim // 4, 2, stride=2, compute_dtype=dt)]
                cin = dim // 4
            elif scale == 2.0:
                layers, cin = [ConvTranspose2d(dim, dim // 2, 2, stride=2, compute_dtype=dt)], \
                    dim // 2
            elif scale == 1.0:
                layers, cin = [], dim
            elif scale == 0.5:
                layers, cin = [nn.MaxPool2d(2, 2)], dim
            else:
                raise ValueError(f"scale factor {scale} (4.0, 2.0, 1.0 or 0.5)")
            layers += [NormConv2d(cin, out, 1, eps, dt), NormConv2d(out, out, 3, eps, dt)]
            name = f"simfp_{int(math.log2(cfg.patch_size / scale))}"
            self.add_module(name, nn.Sequential(*layers))
            self.stages.append(name)

    def windows(self, h: int, w: int) -> int:
        """Windows one image's forward attends (a global block's grid is one)."""
        c = self.cfg
        gh, gw, s = h // c.patch_size, w // c.patch_size, c.window_size
        per = (-(-gh // s)) * (-(-gw // s))
        return sum(per if blk.window else 1 for blk in self.net.blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with annotate("seam.vit"):
            count("vit.attn.fused" if x.is_cuda else "vit.attn.plain", len(self.net.blocks))
            count("vit.windows", self.windows(x.shape[2], x.shape[3]) * x.shape[0])
            # NCHW over channels-last memory, rounded to the compute dtype once
            # (max-pooling commutes with the rounding)
            top = self.net(x).permute(0, 3, 1, 2).to(self.dt)
            feats = [getattr(self, name)(top).to(self.dt) for name in self.stages]
            feats.append(F.max_pool2d(feats[-1], 1, stride=2))
        return tuple(feats)
