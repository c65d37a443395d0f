"""The port's two-bucket phase-1 step against the JAX package's
``Phase1Trainer``, on the CPU (the setting of tests/test_linked_step.py).

A 4-image batch split 3 + 1 into two buckets: the port keeps both buckets'
graphs, computes the match loss once over all slots and takes one backward
and one SGD step; the JAX trainer exports, takes the match gradient and
pulls it back through a rematerialised forward per bucket.  Same weights,
the same per-bucket sampler draws (from each bucket's JAX key), the same
SGD over the same trainable set at lr 0.01, as tests/test_linked_step.py.
"""

import torch

import jax

from seam_match_rcnn_tpu.models.matchrcnn import init_model as jax_init
from seam_match_rcnn_tpu.train.optim import backbone_frozen_mask
from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd
from seam_match_rcnn_tpu.train.steps import Phase1Trainer as JaxPhase1Trainer
from seam_match_rcnn_tpu.train.steps import create_train_state

from seam_match_rcnn_tpu_torch.ckpt.from_jax import load_jax_variables
from seam_match_rcnn_tpu_torch.models.matchrcnn import init_model
from seam_match_rcnn_tpu_torch.train.optim import sgd
from seam_match_rcnn_tpu_torch.train.steps import Phase1Trainer

from test_train_step import make_batch
from torch_port_train_common import (assert_losses_close, assert_state_close, frozen_tensors,
                                     jax_draws, randomize_biases, serving_train_cfg,
                                     split_batch, to_port_batch)

torch.set_num_threads(2)
LR = 0.01
CANVAS = (32, 32)


def test_linked_two_bucket_step_matches_jax():
    cfg = serving_train_cfg(rpn_batch=64, roi_batch=32, pre=60, post=60)
    jmodel, variables = jax_init(cfg, video=False, canvas=CANVAS)
    variables = randomize_biases(variables)
    tx = jax_sgd(lambda s: LR, momentum=0.9, trainable_mask=backbone_frozen_mask)
    batch = make_batch(4, g=3, hw=CANVAS, seed=1)
    buckets = [split_batch(batch, 0, 3), split_batch(batch, 3, 4)]
    rngs = list(jax.random.split(jax.random.PRNGKey(7), 2))
    state, want = JaxPhase1Trainer(jmodel, tx).step(create_train_state(variables, tx), buckets,
                                                    rngs)

    port = load_jax_variables(init_model(cfg, device="cpu"), variables)
    frozen = frozen_tensors(port)
    trainer = Phase1Trainer(port, sgd(port, lambda s: LR, momentum=0.9))
    got = trainer.step([to_port_batch(b) for b in buckets],
                       draws=[jax_draws(r, cfg, b) for r, b in zip(rngs, buckets)])

    assert_losses_close(got, want)
    assert float(want["loss_match"]) > 0
    worst = assert_state_close(port, variables["params"], state.params, state.batch_stats)
    print(f"worst parameter update error / its size: {worst:.3e}")
    after = frozen_tensors(port)
    for k, v in frozen.items():
        assert torch.equal(v, after[k]), k
    assert trainer.optimizer.count == 1
