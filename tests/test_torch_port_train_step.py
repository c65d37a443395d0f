"""The port's fused phase-1 step (one canvas bucket) against the JAX
package's ``make_phase1_step``, on the CPU.

Serving profile (tile-resident RoIAlign forward and its adjoint kernel; the
JAX kernels in interpret mode, the port's wrappers on their plain versions)
with the f32 stem (``serving_train_cfg`` says why), f32 compute, a 64x64
canvas.  Both sides start from the same weights (``ckpt/from_jax``), take
the same sampler draws (from the JAX key tree) and the same SGD (lr 0.01,
momentum 0.9) over the same trainable set; every parameter's update is held
against JAX's relative to its size (``assert_state_close`` says how).
"""

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
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

from test_train_step import make_batch
from torch_port_train_common import (assert_losses_close, assert_state_close, frozen_tensors,
                                     jax_draws, randomize_biases, serving_train_cfg,
                                     to_port_batch)

torch.set_num_threads(2)
LR = 0.01


def test_fused_step_matches_jax():
    cfg = serving_train_cfg()
    jmodel, variables = jax_init(cfg, video=False, canvas=(64, 64))
    variables = randomize_biases(variables)
    tx = jax_sgd(lambda s: LR, momentum=0.9, trainable_mask=backbone_frozen_mask)
    batch = make_batch(2, g=3, hw=(64, 64), seed=3)
    rng = jax.random.PRNGKey(11)
    state, want = make_phase1_step(jmodel, tx)(create_train_state(variables, tx), batch, rng)

    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    frozen = frozen_tensors(port)
    trainer = Phase1Trainer(port, sgd(port, lambda s: LR, momentum=0.9))
    got = trainer.step([to_port_batch(batch)], draws=[jax_draws(rng, cfg, batch)])
    assert cuda_stem.fused_stem.launches == cuda_roi_align.roi_align.launches == 0
    assert cuda_roi_align.roi_align_adjoint.launches == 0

    assert_losses_close(got, want)
    assert float(want["loss_mask"]) > 0 and float(want["loss_match"]) > 0
    worst = assert_state_close(port, variables["params"], state.params, state.batch_stats)
    print(f"worst parameter update error / its size: {worst:.3e}")
    after = frozen_tensors(port)
    for k, v in frozen.items():
        assert torch.equal(v, after[k]), k
    assert trainer.optimizer.count == 1
