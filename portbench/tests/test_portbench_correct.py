"""``correct`` comes out false when the timed path is broken underneath, and for
the precision control; true for a sound run.  The harness's look for a card is
skipped: each run drives a cell's entry on the CPU at small shapes, with the
cell's own limits.  The port computes in float32 here (its CPU kernels are the
plain versions), so a sound run agrees with the reference to rounding."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control
from portbench import run as R

from . import tiny

BENCH = R.load_benchmark()


def _run(cell: str, seed: int, compute_dtype="float32"):
    entry = tiny.entry(cell, seed, compute_dtype)
    res = R.run_cell(BENCH, R.find_cell(BENCH, cell), seed, 0.2, False, device="cpu",
                     entry=entry, log=lambda s: None)
    return res, entry


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_sound_run_is_correct(cell):
    res, _ = _run(cell, 2**33 + 1)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("key", ["scores", "match_features", "aggr_features"])
def test_an_answer_altered_is_not_correct(monkeypatch, key):
    """One descriptor of each forward altered; for the scores, judged by their
    median gap, every score of each forward."""
    from seam_match_rcnn_tpu_torch.eval.runner import InferenceRunner

    forward = InferenceRunner._forward

    def altered(self, pixels, sizes):
        out = forward(self, pixels, sizes)
        if key == "scores":
            out[key] = out[key] + 0.05
        else:
            out[key][0, 0] = out[key][0, 0] + 0.5
        return out

    monkeypatch.setattr(InferenceRunner, "_forward", altered)
    res, _ = _run("seam_serving.index_mf", 2**33 + 2)
    assert not res["correct"], res["checks"]


def test_the_ports_bf16_trunks_are_not_correct(monkeypatch):
    """The port's own bf16 path for the f32 trunks fails ``trunk_gap`` (TF32,
    the other path below f32 with TF32 off, exists on the card alone)."""
    from portbench import model as M

    monkeypatch.setattr(M, "port_config", M.port_config)  # restored after the test
    control.bf16_trunk()
    res, _ = _run("seam_serving.index_mf", 2**33 + 6)
    assert res["checks"]["trunk_gap"]["value"] > res["checks"]["trunk_gap"]["limit"]
    assert not res["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from seam_match_rcnn_tpu_torch.train.optim import SGD

    def frozen(self):
        self.count += 1

    monkeypatch.setattr(SGD, "step", frozen)
    res, _ = _run("matchrcnn_train.phase1_b8", 2**33 + 3)
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0, abs=0.01)  # unmoved
    assert res["checks"]["change_worst"]["value"] == pytest.approx(1.0, abs=0.01)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

    monkeypatch.setattr(Phase1Trainer, "step", control.half_batch_step(Phase1Trainer.step))
    res, _ = _run("matchrcnn_train.phase1_b8", 2**33 + 4)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_the_precision_control_is_not_correct(cell):
    """The reference in scaled float8 in the port's place fails the cell's
    limits (on the card the same control is read at the cell's own size with
    ``python3 -m portbench.control``)."""
    entry = tiny.entry(cell, 2**33 + 5)
    entry.setup_inputs()
    numbers = entry.check(entry.control_outputs())
    limits = R.load_limits(R.find_cell(BENCH, cell))
    assert any(v > limits[k] for k, v in numbers.items()), (numbers, limits)


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, json; from portbench.tests import test_portbench_correct as t; "
            "t._run('seam_serving.index_mf', 7); "
            "from portbench import run; print(json.dumps(run.forbidden_modules())); "
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(R.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    forbidden, tops = [__import__("json").loads(x) for x in out.stdout.splitlines()[-2:]]
    assert forbidden == []
    assert "seam_match_rcnn_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "seam_match_rcnn_tpu"} & set(tops)


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "seam_serving.index_mf", "--seed", "12345678901", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, cwd=str(R.ROOT),
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and np.isfinite(line["metrics"]["index_frames_per_s"]["value"])
