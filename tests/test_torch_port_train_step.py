"""The port's fused phase-1 step (one canvas bucket) against the JAX
package's ``make_phase1_step``, on the CPU.

Serving profile (tile-resident RoIAlign forward and its adjoint kernel; the
JAX kernels in interpret mode, the port's wrappers on their plain versions)
with the f32 stem (``serving_train_cfg`` says why), f32 compute, a 64x64
canvas.  Both sides start from the same weights (``ckpt/from_jax``), take
the same sampler draws (from the JAX key tree) and the same SGD (lr 0.01,
momentum 0.9) over the same trainable set; every parameter's update is held
against JAX's relative to its size (``assert_state_close`` says how).

One JAX step (a module fixture) is held against three port steps: the
fused ``Phase1Trainer`` step, the same step with ``remat_backbone`` (each
bottleneck recomputed in the backward; its update equal to the step without
within 1e-6 of each tensor's update, bit-equal on the CPU), and the
accumulation triple of ``make_phase1_grad_apply`` at weight 1 (bit-equal to
the ``Phase1Trainer`` step).
"""

import dataclasses

import pytest
import torch

import jax

from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.train.optim import backbone_frozen_mask
from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd
from seam_match_rcnn_tpu.train.steps import create_train_state, make_phase1_step

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.ops import cuda_roi_align, cuda_stem
from seam_match_rcnn_tpu_torch.train.optim import sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer, make_phase1_grad_apply

from test_train_step import make_batch
from torch_port_train_common import (assert_losses_close, assert_state_close, frozen_tensors,
                                     jax_draws, randomize_biases, serving_train_cfg,
                                     to_port_batch)

torch.set_num_threads(2)
LR = 0.01


@pytest.fixture(scope="module")
def jax_step():
    cfg = serving_train_cfg()
    jmodel, variables = jax_init(cfg, video=False, canvas=(64, 64))
    variables = randomize_biases(variables)
    tx = jax_sgd(lambda s: LR, momentum=0.9, trainable_mask=backbone_frozen_mask)
    batch = make_batch(2, g=3, hw=(64, 64), seed=3)
    rng = jax.random.PRNGKey(11)
    state, want = make_phase1_step(jmodel, tx)(create_train_state(variables, tx), batch, rng)
    return cfg, variables, batch, jax_draws(rng, cfg, batch), state, want


@pytest.fixture(scope="module")
def port_fused(jax_step):
    """The port's fused step from the JAX weights: (model, losses, count)."""
    cfg, variables, batch, draws, _, _ = jax_step
    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    frozen = frozen_tensors(port)
    trainer = Phase1Trainer(port, sgd(port, lambda s: LR, momentum=0.9))
    got = trainer.step([to_port_batch(batch)], draws=[draws])
    return port, frozen, got, trainer.optimizer.count


def test_fused_step_matches_jax(jax_step, port_fused):
    _, variables, _, _, state, want = jax_step
    port, frozen, got, count = port_fused
    assert cuda_stem.fused_stem.launches == cuda_roi_align.roi_align.launches == 0
    assert cuda_roi_align.roi_align_adjoint.launches == 0

    assert_losses_close(got, want)
    assert float(want["loss_mask"]) > 0 and float(want["loss_match"]) > 0
    worst = assert_state_close(port, variables["params"], state.params, state.batch_stats)
    print(f"worst parameter update error / its size: {worst:.3e}")
    after = frozen_tensors(port)
    for k, v in frozen.items():
        assert torch.equal(v, after[k]), k
    assert count == 1


def test_remat_step_matches_jax_and_the_step_without(jax_step, port_fused):
    cfg, variables, batch, draws, state, want = jax_step
    port = load_jax_variables(init_model(dataclasses.replace(cfg, remat_backbone=True),
                                         device="cpu"), variables)
    assert port.backbone.body.remat
    got = Phase1Trainer(port, sgd(port, lambda s: LR, momentum=0.9)).step(
        [to_port_batch(batch)], draws=[draws])
    assert_losses_close(got, want)
    assert_state_close(port, variables["params"], state.params, state.batch_stats)
    plain = port_fused[0].state_dict()
    before = load_jax_variables(init_model(cfg, device="cpu"), variables).state_dict()
    for k, v in port.state_dict().items():
        size = float((plain[k].double() - before[k].double()).abs().max())
        assert float((v.double() - plain[k].double()).abs().max()) <= 1e-6 * max(size, 1e-30), k
    for k in got:
        assert float(got[k]) == float(port_fused[2][k]), k


def test_grad_apply_at_weight_one_is_the_fused_step(jax_step, port_fused):
    cfg, variables, batch, draws, state, want = jax_step
    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    optimizer = sgd(port, lambda s: LR, momentum=0.9)
    grad_fn, accum_fn, apply_fn = make_phase1_grad_apply(port, optimizer)
    grads, got = grad_fn(to_port_batch(batch), 1.0, draws=draws)
    apply_fn(grads)
    assert optimizer.count == 1
    assert_losses_close(got, want)
    assert_state_close(port, variables["params"], state.params, state.batch_stats)
    fused = port_fused[0].state_dict()
    assert all(torch.equal(v, fused[k]) for k, v in port.state_dict().items())
    assert all(float(got[k]) == float(port_fused[2][k]) for k in got)
