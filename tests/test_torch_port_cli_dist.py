"""The training CLIs on two Gloo ranks of the CPU under torchrun's
environment (``SEAM_MULTIHOST=1``, the env rendezvous), in one spawn:

* ``cli/train_matchrcnn.py`` on the tiny synthetic DF2 fixture of
  tests/test_torch_port_cli_train.py (a 96x128 canvas, 2 products of one
  view a side: 2 steps a rank);
* then ``cli/train_movingfashion.py`` (8 products of 12 frames) and
  ``cli/train_multidf2.py`` (8 products of 4 street views), 4 products a
  rank in product batches of 2 (2 steps a rank), warm-started from the
  phase-1 run's final.pt, with the tiny serving config on a 96x128 canvas.

Each run stops right after its first mid save and resumes under
``--auto_resume``:

* rank 0 alone writes the checkpoints, and one set is left: epoch000.pt and
  final.pt (the phase-2 runs' in-loop evaluation artifacts too: rank 0's
  working directory holds them, rank 1's does not);
* the phase-1 mid file holds both ranks' generator states, [2, n];
* both ranks resume from the same file, mid.pt, each rank's sampler gives
  it its steps_per_epoch (the products over n_shops x W) batches in all,
  and the ranks end bit-equal (every tensor of the model and every
  momentum buffer).
"""

import json
import os
import socket

import pytest

from seam_match_rcnn_tpu_torch.data import convert
from seam_match_rcnn_tpu_torch.data.synthetic import (make_synthetic_df2,
                                                      make_synthetic_movingfashion)
from torch_parallel_worker import WORLD, spawn

CASES = ["cli_train_matchrcnn", "cli_train_movingfashion", "cli_train_multidf2"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fixtures(root):
    """MovingFashion: 8 training products (12 frames of 160x200), the
    first 2 as the test set.  MultiDF2: 8 training products of 4 street and
    4 shop views, and 2 test products of another seed."""
    mf_root = root / "mf_data"
    train = make_synthetic_movingfashion(str(mf_root), n_products=8)
    data = json.loads(open(train).read())
    test = str(mf_root / "test.json")
    with open(test, "w") as f:
        json.dump({k: data[k] for k in sorted(data)[:2]}, f)
    out = {"mf": {"root": str(mf_root), "train": train, "test": test}, "mdf2": {}}
    for name, n, seed in (("train", 8, 0), ("test", 2, 1)):
        img, ann = make_synthetic_df2(str(root / f"mdf2_{name}"), n_products=n,
                                      views_per_side=4, seed=seed)
        path = str(root / f"mdf2_{name}" / "annots.json")
        convert.convert(img, ann, path)
        out["mdf2"].update({name: path, ("images" if name == "train" else "test_images"): img})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dist")
    inputs = dict(_fixtures(root), root=str(root), save_dir=str(root / "ckpt"))
    out = spawn(CASES, inputs, root, env_port=_free_port(), timeout=400.0)
    return root, out


def test_train_matchrcnn_two_ranks_save_resume_and_agree(ranks):
    root, out = ranks
    save_dir = root / "ckpt"
    r0, r1 = (r["cli_train_matchrcnn"] for r in out)
    assert r0["wrote"] == ["mid.pt", "mid.pt", "epoch000.pt", "final.pt"]
    assert r1["wrote"] == []
    assert sorted(p.name for p in (save_dir / "matchrcnn").iterdir()) == ["epoch000.pt",
                                                                         "final.pt"]
    mid = str(save_dir / "matchrcnn" / "mid.pt")
    assert r0["resumed"] == r1["resumed"] == [mid]
    assert r0["mid_step"] == r1["mid_step"] == (0, 0, 1)
    assert r0["mid_generator"][0] == WORLD
    assert r0["count"] == r1["count"] == 2
    assert r0["digest"] == r1["digest"]


@pytest.mark.parametrize("case,tag,save_tag", [("cli_train_movingfashion", "mf", "seam_mf"),
                                               ("cli_train_multidf2", "mdf2", "seam_mdf2")])
def test_phase2_cli_two_ranks_save_resume_and_agree(ranks, case, tag, save_tag):
    root, out = ranks
    r0, r1 = (r[case] for r in out)
    ckpt = root / tag / "ckpt" / save_tag
    # the stopped run wrote the mid file; the rerun rewrote it after its step,
    # then the epoch and the final file (which clear the mid slot)
    assert r0["wrote"] == ["mid.pt", "mid.pt", "epoch000.pt", "final.pt"], r0["wrote"]
    assert r1["wrote"] == []
    assert sorted(p.name for p in ckpt.iterdir()) == ["epoch000.pt", "final.pt"]
    assert r0["resumed"] == r1["resumed"] == [str(ckpt / "mid.pt")]
    # steps_per_epoch = 8 products // (2 a batch x 2 ranks): one batch before
    # the stop, the other after the resume's skip
    assert r0["batches"] == r1["batches"] == [1, 1]
    assert r0["count"] == r1["count"] == 2
    assert r0["artifacts"] == (False, True) and r1["artifacts"] == (False, False)
    assert not os.path.exists(root / tag / "rank1" / "logs_mf")
    assert r0["digest"] == r1["digest"]
