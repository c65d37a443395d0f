"""The port's parallel layer (``seam_match_rcnn_tpu_torch/parallel``) on two
Gloo ranks of the CPU against the JAX package's collectives, sharded
gallery scoring and SEAM head step on the 8-device CPU mesh.

One spawn (``torch_parallel_worker.spawn``) runs every multi-process case of
this file; the JAX side runs here.  Tolerances: the collectives are exact
(the reduced sums within 1e-6); ``score_matrix_sharded`` within the JAX
package's own sharded-versus-single tolerance (rtol 1e-4, atol 1e-5); the
head step within 1e-4 on every parameter and statistic and the loss within
1e-5 (1 + |loss|) of the JAX single-device step, the JAX mesh test's rule
(tests/test_seam_step.py:150-196).  The gate and the backend rule run in
this process.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from seam_match_rcnn_tpu.eval.gallery import score_matrix_sharded as jax_score_sharded
from seam_match_rcnn_tpu.parallel import collectives as jax_collectives
from seam_match_rcnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seam_match_rcnn_tpu.train import seam as jax_seam
from seam_match_rcnn_tpu.train.optim import sgd as jax_sgd

from seam_match_rcnn_tpu_torch.eval.gallery import score_matrix
from seam_match_rcnn_tpu_torch.parallel import collectives as C
from seam_match_rcnn_tpu_torch.parallel import mesh as port_mesh
from test_seam_step import seam_mesh_parity_batch
from torch_parallel_worker import WORLD, heads_from, spawn
from torch_port_seam_common import head_tree, make_heads

try:
    from jax import shard_map
except ImportError:  # older jax spells it experimental
    from jax.experimental.shard_map import shard_map

LR = 0.01  # the JAX mesh test's


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    mp, ta = make_heads(0)
    batch = {k: np.asarray(v) for k, v in seam_mesh_parity_batch(k_rows=16).items()}
    # the port's RoI features are channels-first
    batch["roi_src"] = np.ascontiguousarray(batch["roi_src"].transpose(0, 1, 4, 2, 3))
    return {
        "x": rng.randn(16).astype(np.float32),
        "street": rng.randn(53, 256).astype(np.float32),
        "shop": rng.randn(17, 256).astype(np.float32),
        "w": rng.randn(2, 256).astype(np.float32),
        "b": rng.randn(2).astype(np.float32),
        "heads": {"mp": mp.state_dict(), "ta": ta.state_dict()},
        "seam": batch, "frames": 2, "lr": LR,
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn(["collectives", "score_sharded", "seam_rows_sharded"], inputs,
                 tmp_path_factory.mktemp("parallel"))


def _jax_shard_map(fn, mesh, out_specs):
    kw = dict(mesh=mesh, in_specs=P("data"), out_specs=out_specs)
    try:  # jax>=0.8 spells the varying-ness checker check_vma
        return shard_map(fn, check_vma=False, **kw)
    except TypeError:
        return shard_map(fn, check_rep=False, **kw)


def test_reduce_dict_and_all_gather_match_jax(inputs, ranks):
    mesh = jax_make_mesh(data=WORLD)
    x = jnp.asarray(inputs["x"])
    want = _jax_shard_map(lambda s: jax_collectives.reduce_dict(
        {"loss": jnp.sum(s), "aux": jnp.max(s)}, "data"), mesh, P())(x)
    gathered = np.asarray(_jax_shard_map(lambda s: jax_collectives.all_gather(s, "data"),
                                         mesh, P(None))(x))
    for r in ranks:
        got = r["collectives"]["reduce_dict"]
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(r["collectives"]["all_gather"],
                                      gathered.reshape(r["collectives"]["all_gather"].shape))


def test_gather_objects_uneven_and_rank_helpers(ranks):
    """Payloads of 10 and 110 bytes, as tests/_multihost_worker.py:48-53;
    with one process every helper is the identity (the JAX package's)."""
    for i, r in enumerate(ranks):
        c = r["collectives"]
        assert [g["rank"] for g in c["gather_objects"]] == [0, 1]
        assert [len(g["payload"]) for g in c["gather_objects"]] == [10, 110]
        assert c["broadcast_object"] == "from rank 0"
        assert c["lockstep"] == [0, 1, 2]  # the shorter shard's length on both ranks
        assert c["count"] == (i, WORLD, i == 0)
    assert (C.process_index(), C.process_count(), C.is_main_process()) == (0, 1, True)
    assert C.gather_objects({"a": 1}) == jax_collectives.gather_objects({"a": 1}) == [{"a": 1}]
    x = torch.arange(3.0)
    assert C.all_reduce_sum(x) is x and C.all_gather(x).shape == (1, 3)
    assert C.reduce_dict({"a": x[1]}) == {"a": x[1]}
    assert C.broadcast_object("o") == "o" and list(C.lockstep(range(2))) == [0, 1]
    assert torch.equal(port_mesh.shard_batch({"a": x}, None)["a"], x)


def test_score_matrix_sharded_matches_jax(inputs, ranks):
    args = [inputs[k] for k in ("street", "shop", "w", "b")]
    want = jax_score_sharded(*args, jax_make_mesh(data=1, model=WORLD), axis="model")
    one = score_matrix(*args, device="cpu")
    for r in ranks:
        got = r["score_sharded"]
        assert got.shape == (53, 17)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-7)


def test_seam_head_step_rows_sharded_matches_jax(inputs, ranks):
    """The adversarial layout: product 0's winner rows on the last rank,
    product 3 excluded.  Both ranks end bit-equal."""
    mp, ta = make_heads(0)
    variables = head_tree(mp, ta)
    batch = {k: jnp.asarray(v) for k, v in seam_mesh_parity_batch(k_rows=16).items()}
    tx = jax_sgd(lambda step: LR, 0.9, 5e-4)
    state, want = jax_seam.make_seam_head_step(tx, frames_per_product=2, n_frames=2)(
        jax_seam.create_head_state(variables, tx), batch)
    assert int(batch["shop_row"][3]) == -1 and np.all(np.asarray(batch["prod"][-2:]) == 0)
    got0, got1 = (r["seam_rows_sharded"] for r in ranks)
    assert got0["losses"] == got1["losses"] and got0["digest"] == got1["digest"]
    loss = float(want["loss"])
    assert abs(got0["losses"]["loss"] - loss) < 1e-5 * (1 + abs(loss))
    got_tree = head_tree(*heads_from({k: {n: torch.from_numpy(v) for n, v in d.items()}
                                        for k, d in got0["state"].items()}))
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])  # noqa: E731
    for group in ("params", "batch_stats"):
        want_leaves, got_leaves = flat(getattr(state, group)), flat(got_tree[group])
        assert want_leaves.keys() == got_leaves.keys()
        delta = max(float(np.max(np.abs(np.asarray(got_leaves[k]) - np.asarray(v))))
                    for k, v in want_leaves.items())
        assert delta < 1e-4, (group, delta)


def test_gate_warns_on_torchrun_markers(monkeypatch):
    """Without SEAM_MULTIHOST=1, torchrun's markers warn (each process would
    train alone), and no markers means a silent no-op."""
    monkeypatch.delenv("SEAM_MULTIHOST", raising=False)
    for k in C.TORCHRUN_MARKERS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        C.initialize_distributed()
    assert any(issubclass(w.category, RuntimeWarning) and "SEAM_MULTIHOST" in str(w.message)
               for w in rec)
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("WORLD_SIZE")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        C.initialize_distributed()
    assert not rec


def test_backend_rule_refuses_nccl_where_ranks_share_a_card(monkeypatch):
    monkeypatch.delenv("SEAM_DIST_BACKEND", raising=False)
    assert C.dist_backend(1, 0) == "gloo"  # no card
    assert C.dist_backend(4, 4) == "nccl"
    for requested in (None, "nccl"):
        with pytest.raises(RuntimeError, match="SEAM_DIST_BACKEND=gloo"):
            C.dist_backend(2, 1, requested)
    assert C.dist_backend(2, 1, "gloo") == "gloo"
    monkeypatch.setenv("SEAM_DIST_BACKEND", "gloo")
    assert C.dist_backend(2, 1) == "gloo"
    monkeypatch.setenv("SEAM_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError):
        C.dist_backend(1, 1)
    # the gate on, NCCL asked for on a host without cards: refused before any rendezvous
    monkeypatch.setenv("SEAM_MULTIHOST", "1")
    monkeypatch.setenv("SEAM_DIST_BACKEND", "nccl")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="SEAM_DIST_BACKEND=gloo"):
        C.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        port_mesh.make_mesh(data=2)


def test_make_mesh_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With a process group, the mesh is CUDA's unless the caller asks for the
    CPU; without a card that raises instead of falling back to the CPU."""
    import torch.distributed.device_mesh as dm

    made = []
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dm, "init_device_mesh", lambda dev, shape, **kw: made.append((dev, shape)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_mesh(data=2)
    port_mesh.make_mesh(data=2, device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    port_mesh.make_mesh(data=1, model=2)
    assert made == [("cpu", (2, 1)), ("cuda", (1, 2))]
