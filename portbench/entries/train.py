"""Phase-1 training: ``Phase1Trainer.step`` over the canvas buckets of each batch,
as ``cli/train_matchrcnn.py`` drives it through ``train/engine.py``
(``bucket_batches``, the step, the losses read back as floats).

An item is one step of ``batch_size`` images from a pool of ``batches`` batches,
cycled; the samplers' uniforms are made by the benchmark (``generate.sampler_draws``)
and handed to the step, so that the reference can draw the same.

Set-up builds one trainer, steps it through the pool's first ``checked_steps``
batches (the same call as the window's), reading each step's loss, the
optimizer's first momentum buffers (SGD's first buffer is the gradient it got)
and, after the last of them, each parameter's change; then it steps through the
rest of the pool (the cell's bucket shapes) and hands the trainer to the window.

The comparison (``check``): the reference, in the configuration's compute dtype,
takes the same weights, batches and uniforms through as many steps of plain
``torch.optim.SGD``:

* ``rpn_gap``: the relative gap of the first step's RPN losses (objectness and
  box regression, the step's own output): they see the backbone, the FPN and the
  RPN head, and the anchors they sample follow from the GT and the uniforms
  alone;
* ``change_gap``: the median leaf's gap of the parameters' change over the
  checked steps, each leaf's against the larger of the reference leaf's norm and
  the median leaf's, over the leaves whose first reference gradient is at least
  a thousandth of the median leaf's (the others move by rounding alone);
* ``change_worst``: the worst of those leaves' gaps, so that an update gone
  wrong in one head (box, mask or match), whose leaves are too few to move the
  median, still shows.

Recorded, not judged (``diagnostics``): each step's total loss gap, the first
gradient's median and worst leaves.  With random weights the proposals, the
sampled RoIs and the 8 match slots an image (picked by IoU rank) are discrete
choices that a last-bit difference flips on some seeds (K1 rounds a rare stem
value one bf16 ulp off cuDNN's): a flip moves the step's total loss by up to 8%
and most leaves' first gradient by up to a third in sound runs, as far as the
precision control moves them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import generate
from .. import model as M
from ..reference import transform as rt

LEAF_FLOOR = 1e-3  # leaves under this share of the median leaf's first gradient


def n_anchors(canvas, n_ratios: int = 3) -> int:
    """Anchors of a canvas (a multiple of 32): P2..P5 at strides 4..32, and P6
    the stride-2 subsample of P5."""
    h, w = canvas
    n = sum((h // s) * (w // s) for s in (4, 8, 16, 32))
    return n_ratios * (n + ((h // 32) + 1) // 2 * (((w // 32) + 1) // 2))


def schedule(opt: dict):
    """The reference's MultiStepLR with linear warmup in its first epoch."""
    warm = min(opt["warmup_iters"], opt["steps_per_epoch"] - 1)

    def lr(step: int) -> float:
        epoch = step // opt["steps_per_epoch"]
        decay = opt["gamma"] ** sum(epoch >= m for m in opt["milestones"])
        if warm <= 0 or epoch >= 1:
            return opt["lr"] * decay
        a = min(max(step / warm, 0.0), 1.0)
        return opt["lr"] * decay * (opt["warmup_factor"] * (1 - a) + a)

    return lr


def _norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().to(torch.float32).norm()) for n, t in named.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap between the two norms, against the larger of the
    reference leaf's norm and the median kept leaf's."""
    leaves = [n for n in ref if keep(n)]
    med = float(np.median([ref[n] for n in leaves])) if leaves else 0.0
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


class Entry:
    unit = "images"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, transform=None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.transform = transform

    # ---- the timed path --------------------------------------------------

    def _draws(self, step: int, images):
        """The samplers' uniforms of a step -> (one dict a bucket, rows in the
        bucket's image order; the buckets' image indices).  The port buckets a
        batch by orientation canvas in order of first appearance."""
        mc = M.port_config(self.cfg, self.transform)
        groups: Dict[tuple, list] = {}
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            s = rt.resize_scale(h, w, mc.transform)
            landscape = int(w * s) >= int(h * s)
            groups.setdefault(mc.transform.landscape_canvas if landscape
                              else mc.transform.portrait_canvas, []).append(i)
        canvas_of = {i: c for c, idx in groups.items() for i in idx}
        rows = generate.sampler_draws(
            self.seed, step, [(n_anchors(canvas_of[i]), mc.rpn.post_nms_top_n_train
                               + self.mix["g_max"]) for i in range(len(images))], self.device)
        draws = [{k: torch.stack([rows[i][k] for i in idx]) for k in ("rpn", "roi")}
                 for idx in groups.values()]
        return draws, list(groups.values())

    def _step(self) -> Dict[str, float]:
        from seam_match_rcnn_tpu_torch.train.engine import bucket_batches

        images, targets = self.pool[self.count % len(self.pool)]
        batches = bucket_batches(self.model, images, targets, self.mix["g_max"], self.device)
        draws, groups = self._draws(self.count, images)
        if [b["images"].shape[0] for b in batches] != [len(g) for g in groups]:
            raise RuntimeError("the port's canvas buckets differ from the orientation "
                               f"groups the uniforms were drawn for: {groups}")
        self.count += 1
        return {k: float(v) for k, v in self.trainer.step(batches, draws=draws).items()}

    def setup_inputs(self) -> None:
        """The pool of batches, from the seed."""
        self.pool = generate.training_batches(self.mix, self.seed, self.device)

    def setup(self) -> None:
        from seam_match_rcnn_tpu_torch.train.optim import multistep_warmup_schedule, sgd
        from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

        o = self.cfg["optimizer"]
        clock = M.Clock(self.device)
        self.model = M.port_model(self.cfg, self.seed, self.device, self.transform)
        sched = multistep_warmup_schedule(o["lr"], o["milestones"], o["gamma"],
                                          o["steps_per_epoch"], o["warmup_iters"],
                                          o["warmup_factor"])
        self.optimizer = sgd(self.model, sched, o["momentum"], o["weight_decay"])
        self.trainer = Phase1Trainer(self.model, self.optimizer)
        clock.lap("weights")
        self.setup_inputs()
        clock.lap("inputs")
        self.count = 0
        names = {id(p): n for n, p in self.model.named_parameters()}
        p0 = {names[id(p)]: p.detach().clone() for p in self.optimizer.params}
        self.losses = []
        for s in range(self.mix["checked_steps"]):
            self.losses.append(self._step())
            if s == 0:
                state = self.optimizer.optimizer.state
                self.grad1 = _norms({names[id(p)]: state[p]["momentum_buffer"]
                                     for p in self.optimizer.params if p in state})
        self.change = _norms({names[id(p)]: p.detach() - p0[names[id(p)]]
                              for p in self.optimizer.params})
        del p0
        while self.count < len(self.pool):
            self._step()
        clock.lap("checked steps and warm-up")
        self.phases = clock.laps

    @property
    def cycle(self) -> int:
        return len(self.pool)

    def item(self):
        n = self.mix["batch_size"]
        lf = self._step()
        return n, 0 if np.isfinite(sum(lf.values())) else n

    @staticmethod
    def end_to_end(done: int, seconds: float, lat) -> Dict[str, float]:
        return {"train_img_per_s": done / seconds}

    def release(self) -> None:
        del self.trainer, self.optimizer, self.model
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    # ---- the comparison --------------------------------------------------

    def _reference_steps(self, compute_dtype: str = None):
        """The reference's checked steps -> (losses, first gradient norms,
        change norms) by leaf name.  By default the reference computes in the
        configuration's own compute dtype (bf16, its f32 trunks f32, TF32 off):
        the samplers' discrete choices (proposals, sampled RoIs, match slots)
        then meet the same rounding as in the port, where a float32 reference
        moved most leaves' first gradient by a fifth on a third of the seeds."""
        compute_dtype = compute_dtype or self.cfg["model"]["compute_dtype"]
        ref = M.reference_model(self.cfg, self.seed, self.device, compute_dtype, self.transform)
        named = [(n, p) for n, p in ref.named_parameters() if p.requires_grad]
        p0 = {n: p.detach().clone() for n, p in named}
        o = self.cfg["optimizer"]
        lr = schedule(o)
        opt = torch.optim.SGD([p for _, p in named], lr=lr(0), momentum=o["momentum"],
                              dampening=0.0, weight_decay=o["weight_decay"])
        losses, grad1 = [], {}
        tcfg = ref.cfg.transform
        for s in range(self.mix["checked_steps"]):
            images, targets = self.pool[s]
            draws, groups = self._draws(s, images)
            buckets = []
            for idx in groups:
                pix, sizes, gts = [], [], []
                for i in idx:
                    canvas, (nh, nw) = rt.ingest(images[i], tcfg, self.device)
                    t = dict(targets[i])
                    t["boxes"] = rt.to_canvas_boxes(t["boxes"], (nh, nw), images[i].shape[:2])
                    pix.append(canvas)
                    sizes.append((nh, nw))
                    gts.append(rt.pad_target(t, self.mix["g_max"]))
                buckets.append({
                    "images": torch.cat(pix),
                    "sizes": torch.tensor(sizes, device=self.device),
                    "gt": {k: torch.as_tensor(np.stack([g[k] for g in gts]), device=self.device)
                           for k in gts[0]}})
            opt.zero_grad(set_to_none=True)
            terms = ref.training_losses(buckets, draws)
            total = sum(terms.values())
            total.backward()
            if s == 0:
                grad1 = _norms({n: p.grad for n, p in named if p.grad is not None})
            for g in opt.param_groups:
                g["lr"] = lr(s)
            opt.step()
            losses.append(dict({k: float(v.detach()) for k, v in terms.items()},
                               loss=float(total.detach())))
        change = _norms({n: p.detach() - p0[n] for n, p in named})
        del ref, opt, p0
        return losses, grad1, change

    def control_outputs(self):
        from ..reference.layers import FP8

        return self._reference_steps(FP8)

    def check(self, outputs=None) -> Dict[str, float]:
        losses, grad1, change = ((self.losses, self.grad1, self.change) if outputs is None
                                 else outputs)
        r_losses, r_grad1, r_change = self._reference_steps()
        med = float(np.median(list(r_grad1.values())))
        moving = {n for n, v in r_grad1.items() if v >= LEAF_FLOOR * med}
        g = _leaf_gaps(grad1, r_grad1, lambda n: True)
        c = _leaf_gaps(change, r_change, lambda n: n in moving)
        rpn = lambda d: d["loss_objectness"] + d["loss_rpn_box_reg"]  # noqa: E731
        self.diagnostics = {  # recorded beside the judged numbers, not judged
            "loss_gap_by_step": [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-30)
                                 for a, b in zip(losses, r_losses)],
            "grad_gap": float(np.median(list(g.values()))),
            "grad_worst": sorted(g.items(), key=lambda kv: -kv[1])[:5],
            "change_worst_leaves": sorted(c.items(), key=lambda kv: -kv[1])[:5],
        }
        return {"rpn_gap": abs(rpn(losses[0]) - rpn(r_losses[0])) / max(rpn(r_losses[0]), 1e-30),
                "change_gap": float(np.median(list(c.values()))),
                "change_worst": max(c.values())}

    # ---- operations a unit -----------------------------------------------

    def flops_per_unit(self) -> Dict[str, float]:
        """One image's forward and backward on the reference (a bucket of one),
        with the match trunk's share (f32 in the configuration) apart."""
        from torch.utils.flop_counter import FlopCounterMode

        ref = M.reference_model(self.cfg, self.seed, self.device, transform=self.transform)
        images, targets = self.pool[0]
        canvas, (nh, nw) = rt.ingest(images[0], ref.cfg.transform, self.device)
        t = dict(targets[0])
        t["boxes"] = rt.to_canvas_boxes(t["boxes"], (nh, nw), images[0].shape[:2])
        g = rt.pad_target(t, self.mix["g_max"])
        bucket = {"images": canvas, "sizes": torch.tensor([[nh, nw]], device=self.device),
                  "gt": {k: torch.as_tensor(np.asarray(v)[None], device=self.device)
                         for k, v in g.items()}}
        draws, _ = self._draws(0, images[:1])
        with FlopCounterMode(display=False) as total:
            sum(ref.training_losses([bucket], draws).values()).backward()
        rois = torch.randn(8, 256, 14, 14, device=self.device, requires_grad=True)
        with FlopCounterMode(display=False) as trunk:
            ref.roi_heads["match_predictor"].descriptors(rois, train=True).sum().backward()
        del ref
        f32 = float(trunk.get_total_flops())
        return {"bfloat16": float(total.get_total_flops()) - f32, "float32": f32}
