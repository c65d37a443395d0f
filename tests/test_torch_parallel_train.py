"""The port's global-batch training steps and the runner's mesh path on two
Gloo ranks of the CPU, held against the port's own one-process steps on the
concatenated batch (those are held against the JAX package by
tests/test_torch_port_train_step.py and tests/test_torch_port_seam_step.py).

One spawn (``torch_parallel_worker.spawn``) runs every multi-process case of
this file; the one-process references run here.

* Phase 1, the tiny serving profile (64x64, f32): two global steps of 4
  images, 2 a rank, with the samplers' draws given.  Each step's state is
  within 1e-3 of the one-process update (``compare_head_updates``' rule:
  every parameter's update relative to its size; the BatchNorm statistics
  within rtol 1e-4, atol 1e-5), and the losses within 1e-5 (1 + |loss|).
  The ranks sum the conv weight gradients of their own images and then
  across ranks, in another order than one process over all four: the worst
  parameter is 1.6e-5 of its update off after the first step and 8.6e-5
  after the second, which the momentum and the BatchNorm statistics carry
  on.  The ranks are bit-equal after both steps, momentum included.  Three
  planted faults each miss the one-process update by more than 10% of some
  parameter's update: every gradient summed (the replicated match
  predictor's W-fold), every gradient averaged (each detector gradient
  1/W) and the match loss over one rank's slots (a rank-local BatchNorm).
* Phase 2: the MovingFashion and MultiDF2 head steps over both ranks' own
  product batches (``seam.global_products``) within 1e-5 of the one-process
  step on the concatenated batch, the ranks bit-equal; a rank with no rows
  neither hangs nor diverges, and with no rows on any rank both skip.
* Both phase-2 epoch loops over the mesh, with a stub runner: shards of 4
  and 3 product batches step in lockstep (3 steps on each rank), a batch
  whose shops have no detection on one rank still steps, one with none on
  either rank skips on both, the saves fire at the same steps, and the
  ranks end bit-equal.
* The runner's mesh path (chunk 8 over 2 ranks, 11 images of both
  orientations: the last chunk padded, one rank's half all padding) returns
  the same on every rank, and what the one-process runner returns.
"""

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu_torch.train import seam
from torch_parallel_worker import WORLD, phase1_batches, spawn
from torch_port_seam_common import make_heads, roi_features

torch.set_num_threads(2)

LR = 0.01
N_IMG, D, K = 12, 3, 16
PER_RANK = 2


def _mf_local(seed, p=3, t=3):
    """A rank's MovingFashion product batch: p products of a shop and t
    frames, D detections an image, through ``select_rows_host``."""
    rng = np.random.RandomState(seed)
    outs = []
    for _ in range(N_IMG):
        boxes = np.sort(rng.uniform(0, 100, (D, 4)).astype(np.float32).reshape(D, 2, 2),
                        axis=1).transpose(0, 2, 1).reshape(D, 4)
        outs.append({"scores": rng.uniform(0.2, 1.0, D).astype(np.float32), "boxes": boxes,
                     "valid": np.ones(D, bool)})
    sel = seam.select_rows_host(outs, ([1] + [0] * t) * p, [i // (1 + t) for i in range(N_IMG)],
                                0.5, p, t, K)
    assert sel is not None and sel.valid.sum() > 6
    batch = {k: getattr(sel, k) for k in ("row_img", "row_det", "valid", "types", "prod",
                                          "img_slot", "shop_row")}
    return dict(batch, roi_src=roi_features(rng, N_IMG, D), aggr_weight=np.float32(1.0))


def _mdf2_local(seed, p=3, t=4):
    """A rank's MultiDF2 product batch: products of 4, 3 and 2 street rows
    (the last under the 3 views an aggregation target needs), each with its
    shop row; rows 12-15 padding."""
    rng = np.random.RandomState(seed)
    seq_gather = np.zeros((p, t), np.int32)
    seq_mask = np.zeros((p, t), bool)
    for i, rows in enumerate(([1, 2, 3, 4], [6, 7, 8], [10, 11])):
        seq_gather[i, :len(rows)] = rows
        seq_mask[i, :len(rows)] = True
    return {"row_img": rng.randint(0, N_IMG, K).astype(np.int32),
            "row_det": rng.randint(0, D, K).astype(np.int32),
            "shop_row": np.asarray([0, 5, 9], np.int32), "seq_gather": seq_gather,
            "seq_mask": seq_mask, "roi_src": roi_features(rng, N_IMG, D)}


def _epoch_shard(seed, n_batches, no_shops, mdf2, p=3, t=3, d=3):
    """A rank's product batches for the epoch loops with their recorded
    runner outputs (tests/test_torch_port_seam_engine.py's layout): the
    batches in ``no_shops`` have shops without a detection."""
    rng = np.random.RandomState(seed)
    data, recorded = [], []
    for b in range(n_batches):
        items, outs = [], []
        for prod in rng.choice(10, p, replace=False):
            for tag in [1] + [0] * t:
                boxes = rng.uniform(0, 60, (d, 2))
                boxes = np.concatenate([boxes, boxes + rng.uniform(10, 60, (d, 2))], 1)
                o = {"scores": rng.uniform(0.6, 1.0, d).astype(np.float32),
                     "boxes": boxes.astype(np.float32), "valid": np.ones(d, bool)}
                if b in no_shops and tag == 1:
                    o["scores"][:] = 0.0
                item = {"image": np.zeros((2, 2, 3), np.float32), "tag": tag, "i": int(prod)}
                if mdf2:
                    item.update(key=f"1_{prod}", styles=np.asarray([1]),
                                pair_ids=np.asarray([prod]), boxes=o["boxes"][:1] + 2)
                items.append(item)
                outs.append(o)
        data.append(items)
        recorded.append((outs, roi_features(rng, len(outs), d)))
    return data, recorded


@pytest.fixture(scope="module")
def inputs():
    mp, ta = make_heads(0)
    rng = np.random.RandomState(7)
    sizes = [(60, 80)] * 7 + [(80, 60)] * 4
    return {
        "heads": {"mp": mp.state_dict(), "ta": ta.state_dict()}, "lr": LR,
        "rtol": 1e-3, "fault_rtol": 0.1,
        "mf": {"local": [_mf_local(1), _mf_local(2)], "products": 3, "frames": 3},
        "mdf2": {"local": [_mdf2_local(3), _mdf2_local(4)], "products": 3, "frames": 4},
        "batches": phase1_batches(WORLD * PER_RANK, 2),
        "images": [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes],
        # rank 0: 4 batches, rank 1: 3; batch 1 without shops on rank 1, batch 2 on both
        "epoch": {kind: [_epoch_shard(20 + 2 * i, 4, {2}, kind == "multidf2"),
                         _epoch_shard(21 + 2 * i, 3, {1, 2}, kind == "multidf2")]
                  for i, kind in enumerate(("movingfashion", "multidf2"))},
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn(["phase1", "seam_global", "seam_one_rank_empty", "seam_all_empty",
                  "mdf2_global", "mdf2_one_rank_empty", "epoch_mesh", "runner"], inputs,
                 tmp_path_factory.mktemp("parallel_train"))


def _losses_close(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-5 * (1 + abs(v)), (k, g[k], v)


# ---- phase 1 --------------------------------------------------------------------------

def test_phase1_global_step_equals_one_process_step(ranks):
    """Rank 0 holds its state against the one-process steps; rank 1's is
    bit-equal to it (next test)."""
    got = ranks[0]["phase1"]["ok"]
    for step, v in enumerate(got["verdicts"], 1):
        assert not v["bad"], (step, v)
        print(f"step {step}: worst update error / its size {v['worst']:.3e}")
    _losses_close(got["losses"], got["ref_losses"])


def test_phase1_ranks_end_bit_equal(ranks):
    a, b = (r["phase1"]["ok"] for r in ranks)
    assert a["losses"] == b["losses"]
    assert a["digests"] == b["digests"] and len(a["digests"]) == 2
    assert a["momentum"] > 0  # the momentum buffers are in the digests


@pytest.mark.parametrize("fault", ["w_fold", "one_over_w", "rank_local_bn"])
def test_phase1_planted_fault_is_caught(ranks, fault):
    v = ranks[0]["phase1"][fault]
    assert v["n_bad"] and v["worst"] > 0.1, (fault, v)


# ---- phase 2 --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["seam_global", "seam_one_rank_empty", "mdf2_global",
                                  "mdf2_one_rank_empty"])
def test_head_step_over_both_ranks_equals_one_process(ranks, case):
    """Rows and products of both ranks, rank 1's (MovingFashion) or rank 0's
    (MultiDF2) none in the ``one_rank_empty`` cases: every rank takes the
    step, bit-equal, with the one-process step's update on the
    concatenated batch."""
    a, b = (r[case] for r in ranks)
    assert a["losses"] is not None and a["losses"] == b["losses"]
    assert a["digest"] == b["digest"] and not a["unchanged"]
    for r in (a, b):
        assert not r["verdict"]["bad"], r["verdict"]
        _losses_close([r["losses"]], [r["ref_losses"]])
    assert a["mp_unchanged"] == case.startswith("mdf2")  # frozen in the MultiDF2 step


def test_head_step_with_no_rows_on_any_rank_skips(ranks):
    for r in ranks:
        got = r["seam_all_empty"]
        assert got["losses"] is None and got["unchanged"]


@pytest.mark.parametrize("kind", ["movingfashion", "multidf2"])
def test_epoch_loops_step_in_lockstep(ranks, kind):
    a, b = (r["epoch_mesh"][kind] for r in ranks)
    assert len(a["losses"]) == len(b["losses"]) == 3  # the shorter shard's batches
    assert a["losses"] == b["losses"]
    assert a["losses"][0] is not None and a["losses"][1] is not None  # rank 1 without rows
    assert a["losses"][2] is None  # no rows on either rank: both skip
    assert a["saves"] == b["saves"] == [0, 1]
    assert a["digest"] == b["digest"]


def _assert_bit_equal(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}.{k}")


# ---- the runner ----------------------------------------------------------------------

def test_runner_mesh_returns_what_one_process_returns(ranks):
    """Every rank returns the same results; they are the one-process
    runner's but for the rounding of a forward over 4 images instead of 8
    (CPU convolutions sum in another order): floats within rtol and atol
    1e-4 (the JAX runner's mesh test, tests/test_runner_sharded.py), the
    rest equal."""
    for r in ranks:
        got = r["runner"]
        assert len(got["mesh"]) == len(got["one"]) == 11
        for i, (one, mesh) in enumerate(zip(got["one"], got["mesh"])):
            assert one.keys() == mesh.keys()
            for k, v in one.items():
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(mesh[k], v, rtol=1e-4, atol=1e-4,
                                               err_msg=f"image {i} {k}")
                else:
                    np.testing.assert_array_equal(mesh[k], v, err_msg=f"image {i} {k}")
        np.testing.assert_allclose(got["mesh_dev"], got["one_dev"], rtol=1e-4, atol=1e-4)
    a, b = (r["runner"] for r in ranks)
    for i in range(11):
        _assert_bit_equal(a["mesh"][i], b["mesh"][i], f"image {i}")
    np.testing.assert_array_equal(a["mesh_dev"], b["mesh_dev"])
