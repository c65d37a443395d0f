"""Roofline and FLOP counts against counts done by hand at one small shape."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import peaks
from portbench.entries import train as train_entry
from portbench.reference.heads import TwoMLPHead
from portbench.rooflines import k1, k2, k5


def test_k1_by_hand():
    # B=2, 3x32x64 f32 in, bf16 out: a 7x7 stride-2 conv to 64 channels on 16x32
    flops, nbytes = k1.count(2, 32, 64, 4, 2)
    assert flops == 2 * 2 * 64 * 16 * 32 * 3 * 7 * 7
    assert nbytes == 2 * 3 * 32 * 64 * 4 + 64 * 3 * 49 * 4 + 2 * 64 * 4 + 2 * 64 * 8 * 16 * 2
    x = torch.zeros(2, 3, 32, 64)
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, torch.zeros(64, 3, 7, 7), stride=2, padding=3)
    assert fc.get_total_flops() == flops


def test_k2_and_k5_by_hand():
    # B=1, R=10 rois at 7x7, ratio 2, canvas 64x128: levels 16x32, 8x16, 4x8, 2x4
    cells = 16 * 32 + 8 * 16 + 4 * 8 + 2 * 4
    flops, nbytes = k2.count(1, 10, 7, 2, (64, 128))
    assert nbytes == cells * 256 * 2 + 10 * 16 + 10 * 256 * 49 * 2
    assert flops == 10 * 256 * 49 * 4 * 8
    flops5, nbytes5 = k5.count(1, 10, 7, 2, (64, 128))
    assert nbytes5 == 10 * 256 * 49 * 4 + 10 * 16 + cells * 256 * 2
    # the kernel table's bound: 11 x 4000 rois at 7x7 on 800x1344, bf16
    f, b = k2.count(11, 4000, 7, 2, (800, 1344))
    assert abs(peaks.bound_s(f, b) * 1e3 - 0.4795) < 1e-3


def test_box_head_flops_by_hand():
    head = TwoMLPHead(256, 7, torch.float32)
    with FlopCounterMode(display=False) as fc:
        head(torch.zeros(5, 256, 7, 7))
    assert fc.get_total_flops() == 2 * 5 * (256 * 49 * 1024 + 1024 * 1024)


def test_anchor_count_by_hand():
    # 800x1344: P2..P5 200x336, 100x168, 50x84, 25x42, P6 13x21; 3 ratios
    assert train_entry.n_anchors((800, 1344)) == 3 * (200 * 336 + 100 * 168 + 50 * 84
                                                      + 25 * 42 + 13 * 21)
    assert train_entry.n_anchors((1344, 800)) == train_entry.n_anchors((800, 1344))
