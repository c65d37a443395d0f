"""Multi-process cases of the port's parallel layer, run on Gloo ranks of
the CPU.

``spawn(cases, inputs, tmp_path)`` starts ``world`` ranks with
``torch.multiprocessing.spawn``, which meet through a ``file://``
rendezvous under ``tmp_path`` (no port to collide with), runs each named
case of ``CASES`` on every rank with the pickled ``inputs``, and returns
each rank's outputs.  A rank that raises fails the spawn, and one that
runs past ``timeout`` seconds has every rank killed.  The training cases
also run their one-process reference in the rank and return summaries (the
comparison's verdict, digests of the trained states) rather than states of
a full-width model.  This module imports torch, numpy and the port only, so
that a rank starts quickly.
"""

import copy
import dataclasses
import hashlib
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from seam_match_rcnn_tpu_torch.config import (ModelConfig, RoIHeadsConfig, RPNConfig,
                                              TransformConfig)
from seam_match_rcnn_tpu_torch.models import matchrcnn
from seam_match_rcnn_tpu_torch.models.anchors import grid_anchors
from seam_match_rcnn_tpu_torch.models.match_head import MatchPredictor, TemporalAggregator
from seam_match_rcnn_tpu_torch.parallel import collectives as C
from seam_match_rcnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from seam_match_rcnn_tpu_torch.train.optim import SGD, sgd
from seam_match_rcnn_tpu_torch.train.seam import (compare_head_updates, global_products,
                                                  make_mdf2_head_step, make_seam_head_step)
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

WORLD = 2


def spawn(cases, inputs, tmp_path, world=WORLD, timeout=300.0, env_port=None):
    """With ``env_port`` the ranks get torchrun's environment instead
    (SEAM_MULTIHOST=1, MASTER_ADDR=localhost, MASTER_PORT=env_port, RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) and the cases join the group
    themselves (``initialize_distributed``)."""
    tmp = Path(tmp_path)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.spawn(_rank_main, args=(world, str(tmp), list(cases), env_port), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks of {cases} ran past {timeout} s")
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, tmp, cases, env_port):
    torch.set_num_threads(2)
    if env_port is None:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=world)
    else:
        os.environ.update(SEAM_MULTIHOST="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(env_port), RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = {c: CASES[c](inputs) for c in cases}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def numpy_state(mp_, ta):
    """The heads' state dicts as numpy copies, {"mp": ..., "ta": ...}."""
    return {key: {k: v.detach().cpu().numpy().copy() for k, v in m.state_dict().items()}
            for key, m in (("mp", mp_), ("ta", ta))}


def flat(state):
    return {f"{head}.{k}": v for head, d in state.items() for k, v in d.items()}


def digest(state):
    """A digest of a flat {name: array} state: equal digests, equal bytes."""
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


def verdict(before, want, got, rtol, stats_tol=(1e-4, 1e-5)):
    """``compare_head_updates``' verdict: (the first 5 names outside the
    limit, how many, the worst error over its update)."""
    bad, worst = compare_head_updates(before, want, got, rtol=rtol, stats_tol=stats_tol)
    return {"bad": bad[:5], "n_bad": len(bad), "worst": worst}


# ---- collectives and sharded scoring --------------------------------------------------

def case_collectives(inputs):
    rank = dist.get_rank()
    x = torch.from_numpy(inputs["x"])
    shard = x.reshape(WORLD, -1)[rank]
    return {
        "reduce_dict": {k: float(v) for k, v in C.reduce_dict(
            {"loss": shard.sum(), "aux": shard.max()}).items()},
        "all_gather": C.all_gather(shard).numpy(),
        "gather_objects": C.gather_objects({"rank": rank, "payload": "x" * (10 + 100 * rank)}),
        "broadcast_object": C.broadcast_object(f"from rank {rank}"),
        "lockstep": list(C.lockstep(range(3 + rank))),
        "count": (C.process_index(), C.process_count(), C.is_main_process()),
    }


def case_score_sharded(inputs):
    from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix_sharded

    mesh = make_mesh(data=1, model=WORLD, device_type="cpu")
    return score_matrix_sharded(*(inputs[k] for k in ("street", "shop", "w", "b")), mesh,
                                axis="model", device="cpu")


# ---- phase-2 head steps ---------------------------------------------------------------

def heads_from(state):
    mp_, ta = MatchPredictor(torch.float32), TemporalAggregator(torch.float32, "xla")
    mp_.load_state_dict(state["mp"])
    ta.load_state_dict(state["ta"])
    return mp_, ta


def head_optimizer(params, lr):
    return SGD(list(params), lambda step: lr, 0.9, 5e-4)


def as_tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def case_seam_rows_sharded(inputs):
    """One MovingFashion head step on the rows of ``inputs["seam"]`` sharded
    over the ranks (products, shop rows and RoI source replicated), as the
    JAX mesh step takes them."""
    rank, batch = dist.get_rank(), inputs["seam"]
    k = len(batch["valid"]) // WORLD
    local = {key: (v[rank * k:(rank + 1) * k] if key in (
        "row_img", "row_det", "valid", "types", "prod", "img_slot") else v)
        for key, v in batch.items()}
    mp_, ta = heads_from(inputs["heads"])
    opt = head_optimizer(list(mp_.parameters()) + list(ta.parameters()), inputs["lr"])
    step = make_seam_head_step(mp_, ta, opt, frames_per_product=inputs["frames"], n_frames=2,
                               mesh=make_mesh(data=WORLD, device_type="cpu"))
    losses = step(as_tensors(local))
    state = numpy_state(mp_, ta)
    return {"losses": {k: float(v) for k, v in losses.items()}, "digest": digest(flat(state)),
            "state": state if rank == 0 else None}


def _local_product_batch(local, empty):
    """A rank's own product batch, or one with no rows (a rank whose
    selection was skipped), with its ``has_rows``."""
    batch = {k: np.asarray(v).copy() for k, v in local.items()}
    if empty:
        for key in ("row_img", "row_det", "types", "prod", "img_slot", "seq_gather"):
            if key in batch:
                batch[key][:] = 0
        for key in ("valid", "seq_mask"):
            if key in batch:
                batch[key][:] = False
        batch["shop_row"][:] = -1
    batch["has_rows"] = np.asarray([not empty])
    return batch


def _head_step(inputs, kind, mesh=None):
    mp_, ta = heads_from(inputs["heads"])
    frames = inputs[kind]["frames"]
    if kind == "mdf2":
        step = make_mdf2_head_step(ta, head_optimizer(ta.parameters(), inputs["lr"]), mesh=mesh)
    else:
        step = make_seam_head_step(
            mp_, ta, head_optimizer(list(mp_.parameters()) + list(ta.parameters()),
                                    inputs["lr"]),
            frames_per_product=frames, n_frames=2, mesh=mesh)
    return step, mp_, ta


def _one_process_batch(globals_):
    """The ranks' batches after ``global_products`` (products global, rows
    and images their own) concatenated into the one-process step's batch:
    rank 0's images and rows, then rank 1's."""
    offsets = np.cumsum([0] + [g["roi_src"].shape[0] for g in globals_[:-1]])
    one = {"roi_src": np.concatenate([g["roi_src"] for g in globals_]),
           "row_img": np.concatenate([g["row_img"] + o for g, o in zip(globals_, offsets)]),
           "row_det": np.concatenate([g["row_det"] for g in globals_])}
    for key in ("valid", "types", "prod", "img_slot"):
        if key in globals_[0]:
            one[key] = np.concatenate([g[key] for g in globals_])
    for key in ("shop_row", "seq_gather", "seq_mask", "aggr_weight"):
        if key in globals_[0]:
            one[key] = globals_[0][key]
    return one


def _global_step(inputs, kind, empty_ranks):
    """One mesh head step ("mf" or "mdf2") from the rank-local product
    batches of ``inputs[kind]`` through ``seam.global_products``, ranks in
    ``empty_ranks`` giving no rows, and the one-process step on the
    concatenated batch, held against it (rtol ``inputs["rtol"]``)."""
    rank, case = dist.get_rank(), inputs[kind]
    gather = lambda a: C.all_gather(torch.from_numpy(a)).numpy()  # noqa: E731
    batch = _local_product_batch(case["local"][rank], rank in empty_ranks)
    batch = global_products(batch, rank, WORLD, case["products"], case["frames"], gather)
    step, mp_, ta = _head_step(inputs, kind, make_mesh(data=WORLD, device_type="cpu"))
    losses = step(as_tensors(batch))
    state = flat(numpy_state(mp_, ta))
    before = flat(numpy_state(*heads_from(inputs["heads"])))
    out = {"losses": None if losses is None else {k: float(v) for k, v in losses.items()},
           "digest": digest(state), "unchanged": digest(state) == digest(before),
           "mp_unchanged": all(np.array_equal(v, before[k]) for k, v in state.items()
                               if k.startswith("mp."))}
    if losses is not None:
        ref_step, ref_mp, ref_ta = _head_step(inputs, kind)
        ref = ref_step(as_tensors(_one_process_batch(C.gather_objects(batch))))
        out["ref_losses"] = {k: float(v) for k, v in ref.items()}
        out["verdict"] = verdict(before, flat(numpy_state(ref_mp, ref_ta)), state,
                                 inputs["rtol"])
    return out


def case_seam_global(inputs):
    return _global_step(inputs, "mf", ())


def case_seam_one_rank_empty(inputs):
    return _global_step(inputs, "mf", (1,))


def case_seam_all_empty(inputs):
    return _global_step(inputs, "mf", (0, 1))


def case_mdf2_global(inputs):
    return _global_step(inputs, "mdf2", ())


def case_mdf2_one_rank_empty(inputs):
    return _global_step(inputs, "mdf2", (0,))


class StubRunner:
    """Hands out recorded (outputs, RoI features [N, D, 256, 14, 14]) per
    call, in order (tests/test_torch_port_seam_engine.py's, without JAX)."""

    def __init__(self, recorded):
        self.recorded, self.calls = list(recorded), 0

    def run(self, images, device_keys=None):
        outs, roi = self.recorded[self.calls]
        self.calls += 1
        assert len(images) == len(outs)
        return outs, {"roi_features": torch.from_numpy(roi)}


def case_epoch_mesh(inputs):
    """Both phase-2 epoch loops over a data mesh, each rank on its own
    product batches (``inputs["epoch"][kind][rank]``, shards of unequal
    length), a save after every step: the losses of each step (None where
    the step skipped), the saves and a digest of the heads."""
    from seam_match_rcnn_tpu_torch.train import engine

    rank, out = dist.get_rank(), {}
    for kind in ("movingfashion", "multidf2"):
        data, recorded = inputs["epoch"][kind][rank]
        mp_, ta = heads_from(inputs["heads"])
        mesh = make_mesh(data=WORLD, device_type="cpu")
        if kind == "multidf2":
            step = make_mdf2_head_step(ta, head_optimizer(ta.parameters(), inputs["lr"]),
                                       mesh=mesh)
        else:
            step = make_seam_head_step(
                mp_, ta, head_optimizer(list(mp_.parameters()) + list(ta.parameters()),
                                        inputs["lr"]), frames_per_product=3, n_frames=2,
                mesh=mesh)
        losses, saves = [], []

        def recording(batch, step=step):
            got = step(batch)
            losses.append(None if got is None else {k: float(v) for k, v in got.items()})
            return got

        recording.optimizer, recording.group = step.optimizer, step.group
        loop = getattr(engine, f"train_one_epoch_{kind}")
        loop(StubRunner(recorded), recording, data, epoch=1, n_products=3, frames_per_product=3,
             score_thresh=0.5, max_rows=16, print_freq=100, save_every_steps=1,
             save_fn=saves.append)
        out[kind] = {"losses": losses, "saves": saves, "digest": digest(flat(numpy_state(mp_, ta)))}
    return out


# ---- phase 1 --------------------------------------------------------------------------

def tiny_train_cfg():
    """The phase-1 serving profile at tiny sizes, f32 (the port twin of
    ``torch_port_train_common.serving_train_cfg``)."""
    return ModelConfig(
        rpn=RPNConfig(pre_nms_top_n_train=100, post_nms_top_n_train=150,
                      pre_nms_top_n_test=50, post_nms_top_n_test=80, batch_size_per_image=32),
        roi_heads=RoIHeadsConfig(batch_size_per_image=64, detections_per_img=10,
                                 positive_fraction=0.25, roi_align_backend="pallas_resident"),
        compute_dtype="float32", stem_backend="xla", freeze_backbone_stages=True)


def phase1_batches(n_images, n_steps, seed=3, hw=(64, 64), g=3):
    """``n_steps`` global batches of ``n_images`` images (street and shop
    alternating, pair ids shared across images) with the samplers' draws:
    numpy, one dict a step."""
    cfg = tiny_train_cfg()
    rng = np.random.RandomState(seed)
    h, w = hw
    shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] - 1) // 2 + 1, (shapes[-1][1] - 1) // 2 + 1))
    n_anchors = sum(len(a) for a in grid_anchors(hw, tuple(shapes), tuple(cfg.anchors.sizes),
                                                  tuple(cfg.anchors.aspect_ratios)))
    out = []
    for _ in range(n_steps):
        x1y1 = rng.uniform(0, 30, (n_images, g, 2))
        wh = rng.uniform(10, 30, (n_images, g, 2))
        valid = np.ones((n_images, g), bool)
        valid[:, -1] = False
        out.append({
            "images": rng.rand(n_images, 3, h, w).astype(np.float32),
            "sizes": np.asarray([[h, w]] * n_images, np.int32),
            "gt": {"boxes": np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32),
                   "labels": rng.randint(1, 14, (n_images, g)).astype(np.int64),
                   "valid": valid,
                   "pair_ids": rng.randint(1, 5, (n_images, g)).astype(np.int64),
                   "styles": rng.randint(0, 3, (n_images, g)).astype(np.int64),
                   "source": (np.arange(n_images) % 2).astype(np.int64),
                   "mask_crops": (rng.rand(n_images, g, 28, 28) > 0.4).astype(np.uint8)},
            "draws": {"rpn": rng.rand(n_images, n_anchors).astype(np.float32),
                      "roi": rng.rand(n_images, cfg.rpn.post_nms_top_n_train + g)
                      .astype(np.float32)}})
    return out


def _tensors(batch):
    if isinstance(batch, dict):
        return {k: _tensors(v) for k, v in batch.items()}
    return torch.from_numpy(batch)


_INITIAL = {}


def phase1_model(lr):
    """A fresh tiny model from seed 0 (built once a process, then copied)
    and its SGD."""
    if "model" not in _INITIAL:
        _INITIAL["model"] = matchrcnn.init_model(tiny_train_cfg(), seed=0, device="cpu")
    model = copy.deepcopy(_INITIAL["model"])
    return model, sgd(model, lambda step: lr, momentum=0.9)


def phase1_state(model, optimizer):
    """The trained state: every trainable parameter, the BatchNorm
    statistics and the momentum buffers."""
    out = {n: p.detach().numpy().copy() for n, p in model.named_parameters() if p.requires_grad}
    out.update({n: b.detach().numpy().copy() for n, b in model.named_buffers()
                if "running_" in n})
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    for name, p in zip(names, optimizer.params):
        buf = optimizer.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum:{name}"] = buf.numpy().copy()
    return out


def phase1_run(batches, lr, mesh=None, plant=None):
    """Steps of a fresh tiny model on this rank's share of each global
    batch (``shard_batch``; the whole batch without a mesh); returns the
    state before and after each step and the losses."""
    model, optimizer = phase1_model(lr)
    trainer = Phase1Trainer(model, optimizer, mesh)
    if plant is not None:
        plant(model, optimizer, trainer)
    states, losses = [phase1_state(model, optimizer)], []
    for b in batches:
        part = shard_batch(_tensors(b), mesh)
        out = trainer.step([{k: part[k] for k in ("images", "sizes", "gt")}],
                           draws=[part["draws"]])
        losses.append({k: float(v) for k, v in out.items()})
        states.append(phase1_state(model, optimizer))
    return {"states": states, "losses": losses}


def _plant_w_fold(model, optimizer, trainer):
    # every gradient summed: the replicated match predictor's counts W times
    optimizer.distribute(trainer.group, mean=())


def _plant_one_over_w(model, optimizer, trainer):
    # every gradient averaged: each detector gradient counts 1/W
    optimizer.distribute(trainer.group, mean=optimizer.params)


def _plant_rank_local_bn(model, optimizer, trainer):
    # the match loss over this rank's slots only: its BatchNorm spans one rank
    full = matchrcnn._global_match_batch

    def local(rois, meta, parts, n_images, group):
        _, _, parts, n_images = full(rois, meta, parts, n_images, group)
        return rois, meta, parts, n_images

    matchrcnn._global_match_batch = local


PLANTS = {"w_fold": _plant_w_fold, "one_over_w": _plant_one_over_w,
          "rank_local_bn": _plant_rank_local_bn}


def case_phase1(inputs):
    """The 2-rank steps and the planted faults; rank 0 also runs the
    one-process steps on the whole batch and holds each against them (the
    ranks' digests show that rank 1 holds the same)."""
    lr, batches, rank = inputs["lr"], inputs["batches"], dist.get_rank()
    mesh = make_mesh(data=WORLD, device_type="cpu")
    ok = phase1_run(batches, lr, mesh)
    out = {"ok": {"losses": ok["losses"], "digests": [digest(st) for st in ok["states"][1:]],
                  "momentum": sum(k.startswith("momentum:") for k in ok["states"][-1])}}
    faults = {}
    full = matchrcnn._global_match_batch
    for name, plant in PLANTS.items():
        try:
            faults[name] = phase1_run(batches[:1], lr, mesh, plant)["states"][1]
        finally:
            matchrcnn._global_match_batch = full
    if rank == 0:
        ref = phase1_run(batches, lr)
        params = lambda st: {k: v for k, v in st.items() if not k.startswith("momentum:")}  # noqa
        out["ok"]["verdicts"] = [verdict(params(ref["states"][0]), params(ref["states"][i]),
                                         params(ok["states"][i]), inputs["rtol"])
                                 for i in range(1, len(batches) + 1)]
        out["ok"]["ref_losses"] = ref["losses"]
        for name, got in faults.items():
            out[name] = verdict(params(ref["states"][0]), params(ref["states"][1]),
                                params(got), inputs["fault_rtol"])
    return out


# ---- the runner's mesh path -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Canvas64x96(TransformConfig):
    """Small orientation canvases: a CPU forward of a few images stays cheap
    (tests/torch_port_canvas.py, without its JAX import)."""

    @property
    def landscape_canvas(self):
        return (64, 96)

    @property
    def portrait_canvas(self):
        return (96, 64)


@dataclasses.dataclass(frozen=True)
class Canvas96x128(TransformConfig):
    @property
    def landscape_canvas(self):
        return (96, 128)

    @property
    def portrait_canvas(self):
        return (128, 96)


def tiny_serving_cfg():
    return ModelConfig(rpn=RPNConfig(pre_nms_top_n_test=40, post_nms_top_n_test=48),
                       roi_heads=RoIHeadsConfig(detections_per_img=5),
                       transform=Canvas64x96(min_size=64, max_size=96),
                       compute_dtype="float32")


def case_runner(inputs):
    from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner

    model = matchrcnn.init_model(tiny_serving_cfg(), video=True, seed=0, device="cpu")
    images = inputs["images"]
    kw = dict(chunk=8, with_roi_features=True)
    with torch.no_grad():
        one, one_dev = InferenceRunner(model, **kw).run(images)
        mesh, mesh_dev = InferenceRunner(
            model, mesh=make_mesh(data=WORLD, device_type="cpu"), **kw).run(images)
    return {"one": one, "mesh": mesh, "one_dev": one_dev["roi_features"].numpy(),
            "mesh_dev": mesh_dev["roi_features"].numpy()}



# ---- the phase-1 command line under torchrun's environment ---------------------------

class Stop(Exception):
    pass


def case_cli_train_matchrcnn(inputs):
    """``cli/train_matchrcnn.py --synthetic`` on a 96x128 canvas and a
    fixture of 2 products of one view a side (2 steps a rank): stopped right
    after its first mid save, then rerun with ``--auto_resume``.  Returns
    which files this rank wrote, the file each run resumed from, the mid
    file's generator entry and a digest of the trained model and momentum."""
    import tempfile

    from seam_match_rcnn_tpu_torch.ckpt import io as ckpt_io
    from seam_match_rcnn_tpu_torch.cli import train_matchrcnn
    from seam_match_rcnn_tpu_torch.data import synthetic

    rank = int(os.environ["RANK"])
    tempfile.tempdir = os.path.join(inputs["root"], f"rank{rank}")
    os.makedirs(tempfile.tempdir, exist_ok=True)
    os.chdir(tempfile.tempdir)
    train_matchrcnn.TransformConfig = Canvas96x128
    make = synthetic.make_synthetic_df2
    synthetic.make_synthetic_df2 = lambda root, **kw: make(
        root, **dict(kw, n_products=2, views_per_side=1))
    wrote, resumed, trainers = [], [], []
    replace = os.replace  # every checkpoint lands through os.replace of a staging file
    os.replace = lambda src, dst: (wrote.append(os.path.basename(dst)), replace(src, dst))[1]
    resolve = ckpt_io.resolve_auto_resume
    ckpt_io.resolve_auto_resume = lambda *a: resumed.append(resolve(*a)) or resumed[-1]

    class Trainer(train_matchrcnn.Phase1Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    train_matchrcnn.Phase1Trainer = Trainer
    argv = ["--synthetic", "--device", "cpu", "--save_steps", "1", "--save_epochs", "1",
            "--save_dir", inputs["save_dir"], "--log_dir", os.path.join(inputs["root"], "runs")]
    save_mid = ckpt_io.CheckpointManager.save_mid

    def stop(self, payload):
        save_mid(self, payload)
        raise Stop()

    ckpt_io.CheckpointManager.save_mid = stop
    try:
        train_matchrcnn.main(argv)
    except Stop:
        pass
    ckpt_io.CheckpointManager.save_mid = save_mid
    mid = ckpt_io.restore_checkpoint(os.path.join(inputs["save_dir"], "matchrcnn", "mid.pt"))
    dist.barrier()  # every rank has read the mid file before the rerun replaces it
    try:
        train_matchrcnn.main(argv + ["--auto_resume"])
    finally:  # later cases in this process see the originals
        os.replace, ckpt_io.resolve_auto_resume = replace, resolve
        synthetic.make_synthetic_df2 = make
    model, optimizer = trainers[-1].model, trainers[-1].optimizer
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state.update({f"momentum:{i}": optimizer.optimizer.state[p]["momentum_buffer"].numpy()
                  for i, p in enumerate(optimizer.params)})
    return {"wrote": wrote, "resumed": resumed, "digest": digest(state),
            "count": optimizer.count, "mid_generator": tuple(mid["generator"].shape),
            "mid_step": (mid["epoch"], mid["step_in_epoch"], mid["optimizer_count"])}


# ---- the phase-2 command lines under torchrun's environment ---------------------------

def tiny_cli_cfg():
    """The tiny serving config the phase-2 CLIs get in place of
    ``serving_model_config`` (tests/test_torch_port_cli_train.py's)."""
    return ModelConfig(rpn=RPNConfig(pre_nms_top_n_test=60, post_nms_top_n_test=80),
                       roi_heads=RoIHeadsConfig(detections_per_img=6),
                       transform=Canvas96x128(min_size=96, max_size=128),
                       compute_dtype="float32")


def _phase2_cli(inputs, cli, argv, tag, artifacts):
    """A phase-2 CLI (``cli.main(argv)``, warm-started from the phase-1
    case's final.pt) stopped right after its first mid save and rerun with
    ``--auto_resume``, on a 96x128 canvas.  Returns which files this rank
    wrote, the file each run resumed from, the product batches each run's
    epoch loop took on this rank, whether this rank's working directory holds the
    in-loop evaluation's ``artifacts``, the step count, and a digest of the
    trained model and momentum."""
    from seam_match_rcnn_tpu_torch.ckpt import io as ckpt_io

    rank = int(os.environ["RANK"])
    work = os.path.join(inputs["root"], tag, f"rank{rank}")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)  # the in-loop evaluation writes its artifacts to the cwd
    cli.serving_model_config = tiny_cli_cfg
    wrote, resumed, batches, models, optimizers = [], [], [], [], []
    replace = os.replace
    os.replace = lambda src, dst: (wrote.append(os.path.basename(dst)), replace(src, dst))[1]
    resolve = ckpt_io.resolve_auto_resume
    ckpt_io.resolve_auto_resume = lambda *a: resumed.append(resolve(*a)) or resumed[-1]
    (epoch_name,) = [n for n in vars(cli) if n.startswith("train_one_epoch_")]
    epoch_fn, init_model, sgd_cls = getattr(cli, epoch_name), cli.init_model, cli.SGD

    def counted(data):  # the product batches the epoch loop takes
        batches.append(0)
        for items in data:
            batches[-1] += 1
            yield items

    class Recorded(sgd_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            optimizers.append(self)

    setattr(cli, epoch_name, lambda runner, step, data, *a, **kw: epoch_fn(
        runner, step, counted(data), *a, **kw))
    cli.init_model = lambda *a, **kw: models.append(init_model(*a, **kw)) or models[-1]
    cli.SGD = Recorded
    argv = argv + ["--device", "cpu", "--save_steps", "1", "--epochs", "1", "--eval_freq", "1",
                   "--n_shops", "2", "--frames_per_shop_train", "3", "--frames_per_shop_test",
                   "3", "--print_freq", "1", "--pretrained_path",
                   os.path.join(inputs["save_dir"], "matchrcnn", "final.pt"),
                   "--save_dir", os.path.join(inputs["root"], tag, "ckpt"),
                   "--log_dir", os.path.join(inputs["root"], tag, "runs")]
    save_mid = ckpt_io.CheckpointManager.save_mid

    def stop(self, payload):
        save_mid(self, payload)
        raise Stop()

    ckpt_io.CheckpointManager.save_mid = stop
    try:
        cli.main(argv)
    except Stop:
        pass
    finally:
        ckpt_io.CheckpointManager.save_mid = save_mid
    artifacts_after_stop = os.path.exists(artifacts)
    dist.barrier()  # every rank has stopped before the rerun replaces the mid file
    try:
        cli.main(argv + ["--auto_resume"])
    finally:
        os.replace, ckpt_io.resolve_auto_resume = replace, resolve
        cli.init_model, cli.SGD = init_model, sgd_cls
        setattr(cli, epoch_name, epoch_fn)
    model, optimizer = models[-1], optimizers[-1]
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state.update({f"momentum:{i}": optimizer.optimizer.state[p]["momentum_buffer"].numpy()
                  for i, p in enumerate(optimizer.params) if p in optimizer.optimizer.state})
    return {"wrote": wrote, "resumed": resumed, "batches": batches, "count": optimizer.count,
            "artifacts": (artifacts_after_stop, os.path.exists(artifacts)),
            "digest": digest(state)}


def case_cli_train_movingfashion(inputs):
    """``cli/train_movingfashion.py`` on the fixture of ``inputs["mf"]`` (8
    products, 4 a rank: 2 product batches of 2 a rank) from the phase-1
    file; the rerun skips the first batch and takes the second."""
    from seam_match_rcnn_tpu_torch.cli import train_movingfashion

    mf = inputs["mf"]
    return _phase2_cli(inputs, train_movingfashion,
                       ["--root", mf["root"], "--train_annots", mf["train"], "--test_annots",
                        mf["test"]], "mf", os.path.join("logs_mf", "metrics.json"))


def case_cli_train_multidf2(inputs):
    """``cli/train_multidf2.py`` on the MultiDF2 fixture of ``inputs["mdf2"]``
    (8 products of 4 street views, 4 a rank) from the phase-1 file."""
    from seam_match_rcnn_tpu_torch.cli import train_multidf2

    m = inputs["mdf2"]
    return _phase2_cli(inputs, train_multidf2,
                       ["--root_train", m["images"], "--train_annots", m["train"], "--root_test",
                        m["test_images"], "--test_annots", m["test"]], "mdf2",
                       os.path.join("logs_mdf2", "metrics.json"))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
