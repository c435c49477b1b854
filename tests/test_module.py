"""The in-repo module layer, TrainState and pytree dataclasses: parameter tree
names, rng streams, dtypes, the optimizer update, and that importing the
package pulls in neither flax nor orbax."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgll_tpu.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu.nn import GAT, GCN, GIN, GINNode, GraphSAGE, batch_graphs
from dgll_tpu.nn.module import Dense, Dropout, Module
from dgll_tpu.train import TrainState
from dgll_tpu.utils import struct


@pytest.fixture(scope="module")
def g():
    return gcn_normalize(synthetic_classification_graph(
        n_node=60, avg_degree=4, n_class=3, feat_dim=6, seed=0))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("model,expect", [
    (GCN(hidden=8, n_class=3), {
        "GCNConv_0": {"weight": {"kernel": (6, 8)}, "bias": (8,)},
        "GCNConv_1": {"weight": {"kernel": (8, 3)}, "bias": (3,)}}),
    (GAT(hidden=4, n_class=3, num_heads=2), {
        "GATConv_0": {"weight": {"kernel": (6, 8)}, "attn_src": (2, 4),
                      "attn_dst": (2, 4)},
        "GATConv_1": {"weight": {"kernel": (8, 3)}, "attn_src": (1, 3),
                      "attn_dst": (1, 3)}}),
    (GraphSAGE(hidden=8, n_class=3), {
        "SAGEConv_0": {"neigh": {"kernel": (6, 8)},
                       "self": {"kernel": (6, 8), "bias": (8,)}},
        "SAGEConv_1": {"neigh": {"kernel": (16, 3)},
                       "self": {"kernel": (16, 3), "bias": (3,)}},
        "out_proj": {"kernel": (6, 3), "bias": (3,)}}),
    (GINNode(hidden=8, n_class=3, learn_eps=True), {
        "GINConv_0": {"mlp": {"kernel": (6, 8), "bias": (8,)}, "eps": ()},
        "GINConv_1": {"mlp": {"kernel": (8, 3), "bias": (3,)}, "eps": ()}}),
])
def test_param_tree_names(g, model, expect):
    """Sub-modules are named <Class>_<k> per class (or by name=); modules
    without parameters (Dropout) leave no entry."""
    params = model.init(jax.random.key(0), g, g.node_feat)["params"]
    assert _shapes(params) == expect


def test_gin_graph_readout_tree():
    rng = np.random.default_rng(0)
    graphs = [(rng.integers(0, 5, 8), rng.integers(0, 5, 8),
               rng.normal(size=(5, 4)).astype(np.float32), i % 2) for i in range(3)]
    bg, gid, _ = batch_graphs(graphs)
    params = GIN(hidden=8, n_class=2, n_layers=2).init(
        jax.random.key(0), bg, bg.node_feat, gid, 3)["params"]
    assert sorted(params) == ["Dense_0", "GINConv_0", "GINConv_1"]
    assert params["Dense_0"]["kernel"].shape == (4 + 8 + 8, 2)


def test_init_is_deterministic_and_apply_roundtrips(g):
    model = GCN(hidden=8, n_class=3)
    p1 = model.init(jax.random.key(7), g, g.node_feat)
    p2 = model.init(jax.random.key(7), g, g.node_feat)
    p3 = model.init(jax.random.key(8), g, g.node_feat)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(p1["params"]["GCNConv_0"]["weight"]["kernel"],
                           p3["params"]["GCNConv_0"]["weight"]["kernel"])
    out = model.apply(p1, g, g.node_feat)
    assert out.shape == (g.n_node, 3)
    np.testing.assert_allclose(np.exp(np.asarray(out)).sum(-1), 1.0, rtol=1e-5)


def test_dropout_uses_the_dropout_stream(g):
    model = GCN(hidden=8, n_class=3, dropout=0.5)
    p = model.init(jax.random.key(0), g, g.node_feat)
    det = model.apply(p, g, g.node_feat, deterministic=True)
    a = model.apply(p, g, g.node_feat, deterministic=False,
                    rngs={"dropout": jax.random.key(1)})
    b = model.apply(p, g, g.node_feat, deterministic=False,
                    rngs={"dropout": jax.random.key(1)})
    c = model.apply(p, g, g.node_feat, deterministic=False,
                    rngs={"dropout": jax.random.key(2)})
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c) and not np.allclose(a, det)
    with pytest.raises(ValueError, match="dropout"):
        model.apply(p, g, g.node_feat, deterministic=False)


def test_dropout_scales_kept_units():
    class Drop(Module):
        def __call__(self, x):
            return Dropout(0.25)(x, deterministic=False)

    out = np.asarray(Drop().apply({"params": {}}, jnp.ones((4000,)),
                                  rngs={"dropout": jax.random.key(0)}))
    assert set(np.unique(out)) <= {0.0, np.float32(1 / 0.75)}
    assert abs((out == 0).mean() - 0.25) < 0.03


@pytest.mark.parametrize("dtype,in_dtype,out_dtype", [
    (None, jnp.float32, jnp.float32),
    (None, jnp.bfloat16, jnp.float32),
    (jnp.bfloat16, jnp.float32, jnp.bfloat16),
])
def test_dense_dtype(dtype, in_dtype, out_dtype):
    class One(Module):
        def __call__(self, x):
            return Dense(3, dtype=dtype)(x)

    x = jnp.ones((2, 5), in_dtype)
    p = One().init(jax.random.key(0), x)
    assert p["params"]["Dense_0"]["kernel"].dtype == jnp.float32
    y = One().apply(p, x)
    assert y.dtype == out_dtype
    ref = np.asarray(x, np.float32) @ np.asarray(p["params"]["Dense_0"]["kernel"])
    tol = 1e-2 if jnp.bfloat16 in (in_dtype, out_dtype) else 1e-6
    np.testing.assert_allclose(np.asarray(y, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_shared_instance_shares_params_and_missing_param_raises():
    class Twice(Module):
        def __call__(self, x):
            d = Dense(5, name="shared")
            return d(d(x))

    x = jnp.ones((2, 5))
    p = Twice().init(jax.random.key(0), x)["params"]
    assert list(p) == ["shared"]
    with pytest.raises(KeyError):
        Twice().apply({"params": {}}, x)
    with pytest.raises(RuntimeError):
        Dense(3)(x)  # outside init/apply


@pytest.mark.parametrize("tx", [optax.sgd(0.1), optax.adam(1e-2)])
def test_train_state_apply_gradients_matches_optax(tx):
    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones(3)}
    grads = jax.tree.map(lambda a: 0.5 * a + 1.0, params)
    state = TrainState.create(apply_fn=None, params=params, tx=tx)
    assert state.step == 0
    state2 = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)

    opt = tx.init(params)
    updates, opt = tx.update(grads, opt, params)
    want = optax.apply_updates(params, updates)
    assert int(state2.step) == 1
    for a, b in zip(jax.tree.leaves(state2.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(state2.opt_state), jax.tree.leaves(opt)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_struct_dataclass_static_fields_and_replace():
    @struct.dataclass
    class Pair:
        a: jax.Array
        n: int = struct.field(pytree_node=False, default=0)

    p = Pair(a=jnp.ones(2), n=3)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1                          # n is metadata
    assert jax.tree.map(lambda v: v * 2, p).n == 3
    q = p.replace(n=4)
    assert q.n == 4 and p.n == 3
    with pytest.raises(Exception):
        p.n = 5                                       # frozen
    # static fields key jit's cache: a new value retraces
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n

    f(p), f(p), f(q)
    assert traces == [3, 4]


def test_package_imports_without_flax_or_orbax():
    code = ("import sys, dgll_tpu, dgll_tpu.train, dgll_tpu.nn, dgll_tpu.sampling, "
            "dgll_tpu.parallel, dgll_tpu.run; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'flax', 'orbax'}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
