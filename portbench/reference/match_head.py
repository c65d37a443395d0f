"""Match head and SEAM temporal aggregation.

Frozen copy of ``seam_match_rcnn_tpu_torch/models/match_head.py`` (what the benchmark's
plain reference uses of it); it imports nothing of the port. The NLB runs as torch ops
only (no kernel K3).

Port of ``seam_match_rcnn_tpu/models/match_head.py`` with the reference's
module names (``conv_seq``, ``linear``, ``last``, ``attention_scorer``,
``newnlb``), so one state dict serves both.  Descriptors come from a conv
trunk in ``trunk_dtype``; the BatchNorm, the NLB, the attention pooling and
the pairwise scorer are f32.  ``TemporalAggregator.aggregate`` runs kernel
K3 (``ops/cuda_kernels.nlb_aggregate``) for ``nlb_backend="pallas"`` and
``NonLocalBlock1D`` plus attention pooling as torch ops for ``"xla"``; the
phase-2 head step (``train/seam.py``) asks for ``"xla"`` and f32 convs
whatever the model was built with, as the JAX step builds its own heads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .pairwise import pairwise_match_logits
from .layers import Conv2d


class MaskedBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over [N, C] rows with an optional row-validity mask, in the
    JAX package's operation order (``nn.BatchNorm1d`` keeps only the
    parameter names).

    ``train=False``: running statistics.  ``train=True``: the masked mean
    and biased variance of the valid rows normalize, and the running
    statistics move with momentum 0.1 towards that mean and the unbiased
    variance; when no row is valid the update has weight zero, so an empty
    slot set leaves them as they were.  The caller says which, as the JAX
    ``train=`` flag: the module's own ``training`` mode is not read."""

    def forward(self, x: torch.Tensor, valid=None, train: bool = False) -> torch.Tensor:
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            if valid is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
                m = torch.tensor(self.momentum, device=x.device)
            else:
                w = valid.to(torch.float32)[:, None]
                n = w.sum().clamp(min=1.0)
                mean = (x * w).sum(dim=0) / n
                var = (((x - mean) ** 2) * w).sum(dim=0) / n
                m = self.momentum * (valid.sum() > 0).to(torch.float32)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean) * inv) * self.weight + self.bias


class MatchTrunk(nn.Module):
    """14x14x256 RoI features -> 256-d descriptor: 4 valid 3x3 convs
    (256, 256, 256, 1024) + relu, 6x6 mean + relu, Linear(1024, 256),
    BatchNorm1d."""

    def __init__(self, dt: torch.dtype):
        super().__init__()
        layers = []
        for cin, cout in ((256, 256), (256, 256), (256, 256), (256, 1024)):
            layers += [Conv2d(cin, cout, 3, compute_dtype=dt), nn.ReLU()]
        self.conv_seq = nn.Sequential(*layers)
        self.linear = nn.Sequential(nn.Linear(1024, 256), MaskedBatchNorm1d(256))

    def descriptors(self, x: torch.Tensor, valid=None, train: bool = False,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x [N, 256, 14, 14] -> [N, 256] f32.  ``train``: BatchNorm over this
        batch's ``valid`` rows (all rows when None), as the JAX ``train=True``.
        ``dtype``: the convs compute in it instead of the trunk dtype."""
        for layer in self.conv_seq:
            x = layer(x, dtype) if isinstance(layer, Conv2d) else layer(x)
        # the 6x6 mean and the projection stay f32 whatever the trunk dtype
        x = F.relu(x.to(torch.float32).mean(dim=(2, 3)))
        return self.linear[1](self.linear[0](x), valid=valid, train=train)


class MatchPredictor(MatchTrunk):
    def __init__(self, dt: torch.dtype):
        super().__init__(dt)
        self.last = nn.Linear(256, 2)

    def score_pairs(self, street: torch.Tensor, shop: torch.Tensor) -> torch.Tensor:
        """[N, 256] x [M, 256] -> [N, M, 2] logits of the reference's
        Linear(256, 2) on (street - shop)^2."""
        return pairwise_match_logits(street, shop, self.last.weight, self.last.bias)


class NonLocalBlock1D(nn.Module):
    """Masked concat-affinity non-local block over the frame axis
    (reference nlb.py, sub_sample=False, bn_layer=False): theta/phi/g 1x1
    convs to C/2, f = relu(w1.theta_i + w2.phi_j) over valid keys divided by
    the true length, z = W(f @ g) + x; tracks with <= 1 valid frame are
    passed through.  This is the torch-ops path of kernel K3's NLB."""

    def __init__(self, c: int = 256):
        super().__init__()
        ci = c // 2
        self.theta = nn.Conv1d(c, ci, 1)
        self.phi = nn.Conv1d(c, ci, 1)
        self.g = nn.Conv1d(c, ci, 1)
        self.W = nn.Conv1d(ci, c, 1)
        self.concat_project = nn.Sequential(nn.Conv2d(2 * ci, 1, 1, bias=False), nn.ReLU())

    @staticmethod
    def _dense(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        return x @ conv.weight[:, :, 0].T + conv.bias

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [S, T, C] f32; mask [S, T] bool."""
        ci = self.theta.out_channels
        theta, phi, g = self._dense(self.theta, x), self._dense(self.phi, x), self._dense(self.g, x)
        wcat = self.concat_project[0].weight[0, :, 0, 0]
        a = theta @ wcat[:ci]
        c = phi @ wcat[ci:]
        f = torch.relu(a[:, :, None] + c[:, None, :])
        f = torch.where(mask[:, None, :], f, torch.zeros_like(f))
        n = mask.sum(dim=1).clamp(min=1).to(f.dtype)
        y = (f / n[:, None, None]) @ g
        z = self._dense(self.W, y) + x
        multi = (mask.sum(dim=1) > 1)[:, None, None]
        return torch.where(multi & mask[..., None], z, x)


class TemporalAggregator(MatchTrunk):
    """SEAM temporal aggregation: its own trunk, a non-local block over each
    track's frames, softmax attention pooling into one video descriptor,
    and its own pairwise scorer."""

    def __init__(self, dt: torch.dtype):
        super().__init__(dt)
        self.attention_scorer = nn.Linear(256, 1)
        self.newnlb = NonLocalBlock1D(256)
        self.last = nn.Linear(256, 2)

    def nlb_weights(self) -> Dict[str, torch.Tensor]:
        """The NLB and attention weights in kernel K3's layout."""
        nlb = self.newnlb
        dense = lambda conv: conv.weight[:, :, 0].T
        return {
            "theta_w": dense(nlb.theta), "theta_b": nlb.theta.bias,
            "phi_w": dense(nlb.phi), "phi_b": nlb.phi.bias,
            "g_w": dense(nlb.g), "g_b": nlb.g.bias,
            "wcat": nlb.concat_project[0].weight[0, :, 0, 0],
            "wz_w": dense(nlb.W), "wz_b": nlb.W.bias,
            "att_w": self.attention_scorer.weight[0], "att_b": self.attention_scorer.bias,
        }

    def aggregate(self, seqs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """seqs [S, T, 256] per-frame descriptors; mask [S, T] valid frames
        -> [S, 256] video descriptors.  ``nlb_backend`` overrides the
        module's: training passes "xla", since K3 has no backward."""
        mask = mask.to(torch.bool)
        z = self.newnlb(seqs.to(torch.float32), mask)
        att = self.attention_scorer(z)[..., 0]
        att = torch.where(mask, att, torch.full_like(att, -1e9))
        att = torch.softmax(att, dim=1)
        att = torch.where(mask, att, torch.zeros_like(att))
        return (att[..., None] * z).sum(dim=1)

    def score_pairs(self, street: torch.Tensor, shop: torch.Tensor) -> torch.Tensor:
        return pairwise_match_logits(street, shop, self.last.weight, self.last.bias)
