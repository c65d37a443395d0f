"""The port's checkpoint layer (``ckpt/io``: torch files) and its resume.

The cases of tests/test_ckpt_io.py and tests/test_mid_epoch_resume.py that
apply to files (roundtrip, periodic saves and ``save_epochs`` 0, ``latest()``
over a stale ``final.pt``, staging files skipped, an epoch save superseding
the mid slot, ``resolve_auto_resume``, mid detection, repeated large mid
saves), plus: ``SGD.state_dict`` carries the step count with the momentum
(k steps, save, restore into a fresh model, continue == the run that was
not interrupted, bit for bit), and the phase-1 epoch loop interrupted at a
mid save and resumed from the file (model, optimizer and generator state)
equals the uninterrupted loop bit for bit, on a tiny model: the port's form
of tests/test_mid_epoch_resume.py:85.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from seam_match_rcnn_tpu_torch.ckpt.io import (CheckpointManager, resolve_auto_resume,
                                               restore_checkpoint,
                                               restore_training_checkpoint, save_checkpoint)
from seam_match_rcnn_tpu_torch.config import TransformConfig
from seam_match_rcnn_tpu_torch.train.engine import train_one_epoch_matchrcnn
from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
from torch_port_canvas import small_canvas

torch.set_num_threads(2)


def test_roundtrip_weights_only(tmp_path):
    payload = {"model_state_dict": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                                    "n": torch.tensor(3)},
               "optimizer_state_dict": {"state": {0: {"momentum_buffer": torch.ones(2)}},
                                        "param_groups": [{"lr": 0.1, "params": [0]}]},
               "optimizer_count": 5, "epoch": 7, "tag": "x", "pair": (1, 2.5, None)}
    path = save_checkpoint(str(tmp_path / "ck.pt"), payload)
    back = torch.load(path, map_location="cpu", weights_only=True)
    for b in (back, restore_checkpoint(path)):
        assert b["epoch"] == 7 and b["optimizer_count"] == 5 and b["pair"] == (1, 2.5, None)
        assert torch.equal(b["model_state_dict"]["w"], payload["model_state_dict"]["w"])
        assert torch.equal(b["optimizer_state_dict"]["state"][0]["momentum_buffer"],
                           torch.ones(2))
    assert os.listdir(tmp_path) == ["ck.pt"]  # no staging file left
    with pytest.raises(TypeError, match="ndarray"):
        save_checkpoint(str(tmp_path / "np.pt"), {"rng": np.zeros(2)})


def test_checkpoint_manager_periodic(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpts"), save_epochs=2)
    for ep in range(4):
        mgr.maybe_save(ep, {"epoch": ep, "x": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["epoch000.pt", "epoch002.pt"]
    mgr.maybe_save(3, {"epoch": 3, "x": torch.zeros(2)}, final=True)
    assert mgr.latest().endswith("final.pt")
    assert restore_checkpoint(mgr.latest())["epoch"] == 3


def test_maybe_save_zero_save_epochs(tmp_path):
    """save_epochs 0 disables periodic saves (final only), not a crash."""
    mgr = CheckpointManager(str(tmp_path), save_epochs=0)
    mgr.maybe_save(0, {"x": 1})
    assert mgr.latest() is None
    mgr.maybe_save(3, {"x": 2}, final=True)
    assert mgr.latest().endswith("final.pt")


def test_latest_prefers_newer_epoch_over_stale_final(tmp_path):
    """A completed run's final.pt is older than a relaunch's epoch saves:
    latest() ranks by mtime, not by name ('final' > 'epochNNN')."""
    mgr = CheckpointManager(str(tmp_path), save_epochs=2)
    mgr.maybe_save(11, {"x": 1}, final=True)
    mgr.maybe_save(14, {"x": 2})
    old = time.time() - 3600
    os.utime(tmp_path / "final.pt", (old, old))
    assert mgr.latest() == str(tmp_path / "epoch014.pt")
    mgr.save_mid({"x": 3, "step_in_epoch": 0})  # the mid slot is the newest of all
    assert mgr.latest() == str(tmp_path / "mid.pt")
    # an mtime tie goes to the name
    t = time.time()
    for name in ("epoch014.pt", "mid.pt"):
        os.utime(tmp_path / name, (t, t))
    assert mgr.latest() == str(tmp_path / "mid.pt")


def test_latest_skips_staging_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_epochs=2)
    mgr.maybe_save(0, {"x": 1})
    for leftover in (".mid-123-0.pt", ".epoch002.pt.77.tmp"):
        shutil.copy(tmp_path / "epoch000.pt", tmp_path / leftover)
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert mgr.latest() == str(tmp_path / "epoch000.pt")
    mgr._clear_mid()
    assert sorted(os.listdir(tmp_path)) == ["epoch000.pt", "notes.txt"]


def test_epoch_save_supersedes_mid_slot(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_epochs=1)
    state = {"w": torch.tensor(1.0)}
    mgr.save_mid({"state": state, "epoch": 0, "step_in_epoch": 5})
    assert mgr.latest().endswith("mid.pt")
    mgr.maybe_save(0, {"state": state, "epoch": 0})
    assert mgr.latest().endswith("epoch000.pt")
    assert not os.path.exists(tmp_path / "mid.pt")
    # a crash-leftover staging file is never picked, and is swept with the slot
    mgr.save_mid({"state": state, "epoch": 1, "step_in_epoch": 2})
    shutil.copy(tmp_path / "mid.pt", tmp_path / ".mid-123-0.pt")
    assert mgr.latest().endswith("mid.pt")
    mgr.maybe_save(1, {"state": state, "epoch": 1})
    assert mgr.latest().endswith("epoch001.pt")
    assert not any(e.startswith(".mid") or e == "mid.pt" for e in os.listdir(tmp_path))


def test_resolve_auto_resume(tmp_path):
    assert resolve_auto_resume(str(tmp_path), "tag") is None
    mgr = CheckpointManager(str(tmp_path / "tag"), save_epochs=1)
    assert resolve_auto_resume(str(tmp_path), "tag") is None
    mgr.maybe_save(0, {"epoch": 0})
    assert resolve_auto_resume(str(tmp_path), "tag").endswith("epoch000.pt")
    mgr.save_mid({"epoch": 1, "step_in_epoch": 0})
    assert resolve_auto_resume(str(tmp_path), "tag").endswith("mid.pt")


def test_save_mid_roundtrip_and_detection(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_epochs=2)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    gen = torch.Generator().manual_seed(3)
    torch.rand(4, generator=gen)
    path = mgr.save_mid({"model_state_dict": state, "epoch": 4, "step_in_epoch": 17,
                         "generator": gen.get_state()})
    payload, is_mid = restore_training_checkpoint(path)
    assert is_mid and payload["epoch"] == 4 and payload["step_in_epoch"] == 17
    other = torch.Generator()
    other.set_state(payload["generator"])
    assert torch.equal(torch.rand(3, generator=other), torch.rand(3, generator=gen))
    assert torch.equal(payload["model_state_dict"]["w"], state["w"])
    mgr.save_mid({"model_state_dict": state, "epoch": 4, "step_in_epoch": 19})
    payload, is_mid = restore_training_checkpoint(path)
    assert is_mid and payload["step_in_epoch"] == 19 and "generator" not in payload
    mgr.maybe_save(2, {"model_state_dict": state, "epoch": 2})
    payload, is_mid = restore_training_checkpoint(str(tmp_path / "epoch002.pt"))
    assert not is_mid and payload["epoch"] == 2


def test_save_mid_repeated_large_payloads(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_epochs=2)
    big = torch.arange(1_600_000, dtype=torch.float32)  # 6.4 MB
    for step in range(3):
        mgr.save_mid({"state": {"w": big + step}, "epoch": 0, "step_in_epoch": step})
    payload, is_mid = restore_training_checkpoint(mgr.latest())
    assert is_mid and payload["step_in_epoch"] == 2
    assert torch.equal(payload["state"]["w"], big + 2)
    assert os.listdir(tmp_path) == ["mid.pt"]


def _net(seed=0):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(5, 8), torch.nn.ReLU(), torch.nn.Linear(8, 3),
                              torch.nn.Linear(3, 2))
    net[2].requires_grad_(False)  # a frozen layer between trainable ones
    return net


def _schedule():
    return multistep_warmup_schedule(0.1, (4,), 0.1, 3, 5, 0.001)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_sgd_state_dict_resumes_bit_equal(tmp_path, clip):
    x = torch.randn(6, 16, 5, generator=torch.Generator().manual_seed(1))

    def run(net, opt, steps):
        for i in steps:
            opt.zero_grad()
            (net(x[i]) ** 2).mean().backward()
            opt.step()

    full = _net()
    opt = sgd(full, _schedule(), 0.9, 1e-3, clip)
    run(full, opt, range(6))

    part = _net()
    opt = sgd(part, _schedule(), 0.9, 1e-3, clip)
    run(part, opt, range(3))
    path = save_checkpoint(str(tmp_path / "s.pt"),
                           {"model_state_dict": part.state_dict(), **opt.state_dict()})
    payload = restore_checkpoint(path)
    assert payload["optimizer_count"] == 3
    resumed = _net(seed=9)  # other weights, overwritten by the file
    resumed.load_state_dict(payload["model_state_dict"])
    opt2 = sgd(resumed, _schedule(), 0.9, 1e-3, clip)
    opt2.load_state_dict(payload)
    assert opt2.count == 3
    run(resumed, opt2, range(3, 6))
    for (k, a), b in zip(full.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), k
    # without the count the warmup restarts, and the run differs
    lost = _net()
    lost.load_state_dict(payload["model_state_dict"])
    opt3 = sgd(lost, _schedule(), 0.9, 1e-3, clip)
    opt3.optimizer.load_state_dict(payload["optimizer_state_dict"])
    run(lost, opt3, range(3, 6))
    assert not torch.equal(lost[0].weight, full[0].weight)


class _TinyModel(torch.nn.Module):
    """What ``train_one_epoch_matchrcnn`` reads of a model (``cfg.transform``
    and a parameter's device), with two layers to train."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.cfg = type("Cfg", (), {"transform": small_canvas(TransformConfig, (48, 64))(
            min_size=48, max_size=64)})()
        self.a = torch.nn.Linear(3, 4)
        self.b = torch.nn.Linear(4, 1)


class _TinyTrainer:
    """A phase-1 step over the buckets' pixels and GT boxes plus a draw from
    the generator, so that any divergence in batch order, generator state,
    optimizer state or schedule shows in the parameters."""

    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer

    def step(self, batches, generator):
        self.optimizer.zero_grad()
        loss = 0.0
        for b in batches:
            feats = b["images"].mean(dim=(2, 3))  # [B, 3]
            noise = torch.rand(feats.shape, generator=generator)
            out = self.model.b(torch.tanh(self.model.a(feats + noise)))
            loss = loss + (out.squeeze(1) - b["gt"]["boxes"].sum(dim=(1, 2)) / 100).pow(2).sum()
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}


def _batches(n, skip=0):
    rng = np.random.RandomState(0)
    for i in range(n):
        sizes = [(40, 56), (56, 40)] if i % 2 else [(40, 56), (44, 60)]  # 2 or 1 buckets
        imgs = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
        tgts = [{"boxes": np.asarray([[1.0, 2.0, 20.0 + i, 30.0]], np.float32),
                 "labels": np.asarray([1 + i % 3]), "pair_ids": np.asarray([1]),
                 "styles": np.asarray([1]), "sources": np.asarray([j % 2]),
                 "mask_crops": np.zeros((1, 8, 8), np.uint8)} for j in range(2)]
        if i >= skip:
            yield imgs, tgts, [2 * i, 2 * i + 1]


def test_phase1_epoch_interrupted_and_resumed_equals_uninterrupted(tmp_path):
    n = 6

    def fresh():
        model = _TinyModel()
        opt = sgd(model, _schedule(), 0.9, 1e-4, 1.0)
        return model, opt, _TinyTrainer(model, opt), torch.Generator().manual_seed(7)

    model, opt, trainer, gen = fresh()
    train_one_epoch_matchrcnn(model, trainer, _batches(n), 0, gen, g_max=4)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    full_gen, full_count = gen.get_state(), opt.count

    class Stop(Exception):
        pass

    for cut in (1, 3):  # mid saves after batches 2 and 4
        mgr = CheckpointManager(str(tmp_path / f"cut{cut}"))
        model, opt, trainer, gen = fresh()

        def save_fn(step_in_epoch):
            mgr.save_mid({"model_state_dict": model.state_dict(), **opt.state_dict(),
                          "epoch": 0, "step_in_epoch": step_in_epoch,
                          "generator": gen.get_state()})
            if step_in_epoch == cut:
                raise Stop

        with pytest.raises(Stop):
            train_one_epoch_matchrcnn(model, trainer, _batches(n), 0, gen, g_max=4,
                                      save_every_steps=2, save_fn=save_fn)
        payload, is_mid = restore_training_checkpoint(mgr.latest())
        assert is_mid and payload["step_in_epoch"] == cut
        model, opt, trainer, gen = fresh()
        model.load_state_dict(payload["model_state_dict"])
        opt.load_state_dict(payload)
        gen.set_state(payload["generator"])
        skip = payload["step_in_epoch"] + 1
        saves = []
        train_one_epoch_matchrcnn(model, trainer, _batches(n, skip), 0, gen, g_max=4,
                                  start_step=skip, save_every_steps=2, save_fn=saves.append)
        assert saves == [s for s in (1, 3, 5) if s >= skip]  # the counter kept its place
        assert opt.count == full_count == n
        assert torch.equal(gen.get_state(), full_gen)
        for k, v in model.state_dict().items():
            assert torch.equal(v, full[k]), (cut, k)
