"""Checkpoint/resume: save, restore, keep-k, resume training."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from dgll_tpu.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu.nn import GCN
from dgll_tpu.train import CheckpointManager, FullBatchTrainer, create_train_state


@pytest.fixture(scope="module")
def setup():
    g = gcn_normalize(synthetic_classification_graph(n_node=120, avg_degree=6,
                                                     n_class=3, feat_dim=8, seed=0))
    model = GCN(hidden=8, n_class=3, dropout=0.0)
    return g, model


def test_save_restore_roundtrip(tmp_path, setup):
    g, model = setup
    tr = FullBatchTrainer(model, optax.adam(1e-2))
    state, _ = tr.fit(g, g.node_feat, g.labels, g.train_mask, epochs=3)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    params_np = jax.tree.map(np.asarray, state.params)
    mgr.save(3, params_np, wait=True)
    assert mgr.latest_step() == 3

    template = jax.tree.map(np.zeros_like, params_np)
    restored = mgr.restore(template)
    flat_a = jax.tree.leaves(params_np)
    flat_b = jax.tree.leaves(restored)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(a, b)
    mgr.close()


def test_keep_k_and_resume(tmp_path, setup):
    g, model = setup
    tr = FullBatchTrainer(model, optax.adam(1e-2))
    state, _ = tr.fit(g, g.node_feat, g.labels, g.train_mask, epochs=2)
    mgr = CheckpointManager(str(tmp_path / "ckpt2"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, jax.tree.map(np.asarray, state.params), wait=True)
    assert mgr.latest_step() == 3

    # resume: restore into a fresh state and keep training
    restored = mgr.restore(jax.tree.map(np.zeros_like,
                                        jax.tree.map(np.asarray, state.params)))
    state2 = create_train_state(model, jax.random.key(0), optax.adam(1e-2),
                                g, g.node_feat)
    state2 = state2.replace(params=jax.tree.map(jnp.asarray, restored))
    state2, _ = tr.fit(g, g.node_feat, g.labels, g.train_mask, epochs=2, state=state2)
    mgr.close()


def test_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    assert mgr.restore({"w": np.zeros(3)}) is None
    mgr.close()


def test_keep_last_k_prunes_oldest_and_restores_any_kept_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(step, {"w": np.full(3, step, np.float32)})
    assert mgr.steps() == [15, 20]
    assert sorted(os.listdir(tmp_path / "k")) == ["ckpt_0000000015.npz",
                                                  "ckpt_0000000020.npz"]
    got = mgr.restore({"w": np.zeros(3, np.float32)}, step=15)
    np.testing.assert_array_equal(got["w"], np.full(3, 15, np.float32))


def test_train_state_roundtrip_keeps_tree_and_dtypes(tmp_path, setup):
    """A whole TrainState (step, params, adam moments) saves and restores into
    a fresh state's structure; static fields come from the template."""
    g, model = setup
    tr = FullBatchTrainer(model, optax.adam(1e-2))
    state, _ = tr.fit(g, g.node_feat, g.labels, g.train_mask, epochs=2)
    mgr = CheckpointManager(str(tmp_path / "ts"))
    mgr.save(2, state)
    fresh = create_train_state(model, jax.random.key(1), optax.adam(1e-2),
                               g, g.node_feat)
    back = mgr.restore(fresh)
    assert jax.tree.structure(back) == jax.tree.structure(fresh)
    assert int(back.step) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_save_is_atomic_and_restore_checks_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, {"w": np.ones((2, 3), np.float32)})
    # nothing but the finished file is left behind
    assert os.listdir(tmp_path / "a") == ["ckpt_0000000001.npz"]
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": np.zeros((3, 2), np.float32)})
    with pytest.raises(KeyError):
        mgr.restore({"v": np.zeros((2, 3), np.float32)})
