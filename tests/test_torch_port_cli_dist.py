"""``cli/train_matchrcnn.py`` on two Gloo ranks of the CPU under torchrun's
environment (``SEAM_MULTIHOST=1``, the env rendezvous), on the tiny
synthetic DF2 fixture of tests/test_torch_port_cli_train.py (a 96x128
canvas, 2 products of one view a side: 2 steps a rank).  The run stops
right after its first mid save and resumes under ``--auto_resume``:

* rank 0 alone writes the checkpoints (mid.pt twice, epoch000.pt,
  final.pt), and one set is left: epoch000.pt and final.pt;
* the mid file holds both ranks' generator states, [2, n];
* both ranks resume from the same file, mid.pt, and end bit-equal (every
  tensor of the model and every momentum buffer).
"""

import socket

from torch_parallel_worker import WORLD, spawn


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_train_matchrcnn_two_ranks_save_resume_and_agree(tmp_path):
    save_dir = tmp_path / "ckpt"
    out = spawn(["cli_train_matchrcnn"], {"root": str(tmp_path), "save_dir": str(save_dir)},
                tmp_path, env_port=_free_port())
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
