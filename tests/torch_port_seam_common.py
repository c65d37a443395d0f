"""Shared set-up of the port's phase-2 tests against the JAX package: the two
heads with seeded random weights, the same weights as JAX variables (through
the JAX package's own converter), the optimizers of both sides, and the
comparison of trained heads."""

import numpy as np
import torch

import jax

from seam_match_rcnn_tpu.ckpt.torch_convert import _match_predictor, _temporal_aggregator
from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd

from seam_match_rcnn_tpu_torch.models.match_head import MatchPredictor, TemporalAggregator
from seam_match_rcnn_tpu_torch.train.optim import SGD
from seam_match_rcnn_tpu_torch.train.seam import compare_head_updates

# SEAMTrainConfig's momentum and decay, and a smaller lr than its 0.04: the
# f32 backward of the trunk convs differs between XLA and oneDNN by ~2e-4 of
# an update (through the ReLU gates and a BatchNorm over a few rows), and a
# step's loss inherits the last update's error, in proportion to the lr
LR, MOMENTUM, WD = 0.002, 0.9, 5e-4
MP, TA = "roi_heads.match_predictor", "roi_heads.temporal_aggregator"


def make_heads(seed=0, nlb_backend="xla"):
    """The port's match predictor and temporal aggregator (f32 trunks) on the
    CPU, every tensor drawn from ``seed``: weights N(0, 1/fan_in), biases and
    the NLB's W_z non-zero, BatchNorm affines and running statistics away
    from their init, so that every gradient and statistic is exercised."""
    rng = np.random.RandomState(seed)
    mp, ta = MatchPredictor(torch.float32), TemporalAggregator(torch.float32, nlb_backend)
    with torch.no_grad():
        for mod in (mp, ta):
            for name, t in list(mod.named_parameters()) + list(mod.named_buffers()):
                if name.endswith("num_batches_tracked"):
                    continue
                if name.endswith("running_var"):
                    v = rng.uniform(0.5, 1.5, t.shape)
                elif name.endswith("running_mean"):
                    v = rng.randn(*t.shape) * 0.1
                elif name.startswith("linear.1.") and name.endswith("weight"):
                    v = 1.0 + 0.1 * rng.randn(*t.shape)
                elif t.dim() >= 2:
                    v = rng.randn(*t.shape) / np.sqrt(t[0].numel())
                else:
                    v = rng.randn(*t.shape) * 0.05
                t.copy_(torch.from_numpy(v.astype(np.float32)))
    return mp, ta


def head_tree(mp, ta):
    """The heads as the JAX head variables {"params", "batch_stats"}, copied:
    JAX on the CPU may alias a numpy buffer, and the port trains in place."""
    sd = {f"{MP}.{k}": v.detach().cpu().numpy().copy() for k, v in mp.state_dict().items()}
    sd.update({f"{TA}.{k}": v.detach().cpu().numpy().copy() for k, v in ta.state_dict().items()})
    mpp, mps = _match_predictor(sd)
    tap, tas = _temporal_aggregator(sd)
    return {"params": {"match_predictor": mpp, "temporal_aggregator": tap},
            "batch_stats": {"match_predictor": mps, "temporal_aggregator": tas}}


def roi_features(rng, n, d):
    """[n, d, 256, 14, 14] f32 RoI features: noise around a per-detection,
    per-channel level.  The level survives the trunk's 6x6 mean pooling, so
    that descriptors differ across rows as real ones do; i.i.d. noise alone
    pools to near-equal rows, whose BatchNorm divides by a tiny variance and
    makes the step ill-conditioned."""
    return (rng.randn(n, d, 256, 14, 14) + 2.0 * rng.randn(n, d, 256, 1, 1)).astype(np.float32)


def port_sgd(params):
    return SGD(params, lambda step: LR, MOMENTUM, WD)


def jax_tx():
    return jax_sgd(lambda step: LR, MOMENTUM, WD)


def assert_heads_close(mp, ta, params0, params, batch_stats, rtol=5e-3,
                       stats_tol=(1e-4, 1e-5)):
    """The port's heads after some steps against the JAX state, both from
    ``params0``, by ``train.seam.compare_head_updates``: each leaf's update
    within ``rtol`` of the JAX update's norm (plus 1e-6 of the whole
    update's, for leaves whose update is 0), the rule of
    ``torch_port_train_common.assert_state_close``; BatchNorm statistics
    within ``stats_tol`` (rtol, atol).  Returns the worst leaf's error over
    its size."""
    def flat(variables):
        return {f"{group}{jax.tree_util.keystr(path)}": leaf
                for group in ("params", "batch_stats") if group in variables
                for path, leaf in jax.tree_util.tree_flatten_with_path(variables[group])[0]}

    want = flat({"params": params, "batch_stats": batch_stats})
    bad, worst = compare_head_updates(
        flat({"params": params0}), want, flat(head_tree(mp, ta)),
        stats=[k for k in want if k.startswith("batch_stats")], rtol=rtol, stats_tol=stats_tol)
    assert not bad, bad
    return worst


def state_copy(*mods):
    """Every parameter and buffer of ``mods``, cloned."""
    return [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in mods]
