"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4's Gloo-trick twin)."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import PartitionSpec as P

from dgll_tpu.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu.nn import GraphSAGE
from dgll_tpu.ops import spmm_coo
from dgll_tpu.parallel import (
    ShardedDataLoader,
    make_dp_block_step,
    make_mesh,
    make_sharded_spmm,
    partition_graph,
    shard_partitioned_graph,
)
from dgll_tpu.sampling import HostGraph, NeighborSampler
from dgll_tpu.train.metrics import masked_nll_loss


@pytest.fixture(scope="module")
def g():
    return gcn_normalize(
        synthetic_classification_graph(n_node=400, avg_degree=6, n_class=4, feat_dim=16, seed=0)
    )


def test_eight_devices_present():
    assert jax.device_count() == 8


def test_partition_preserves_edges(g):
    pg = partition_graph(g, 4)
    # every real edge appears exactly once with its weight
    w_sum = float(jnp.sum(pg.edge_weight))
    np.testing.assert_allclose(w_sum, float(jnp.sum(g.edge_weight)), rtol=1e-5)
    assert pg.src.shape[0] == 4 and pg.src.shape == pg.dst_local.shape


@pytest.mark.parametrize("strategy", ["contiguous", "bfs"])
def test_sharded_spmm_matches_single_device(g, strategy):
    mesh = make_mesh(("data",))
    pg = partition_graph(g, mesh.devices.size, strategy=strategy)
    pgs = shard_partitioned_graph(pg, mesh)
    spmm = make_sharded_spmm(mesh, pgs)

    x = pg.node_feat  # relabeled order
    out = np.asarray(spmm(x))

    # reference: single-device spmm in the same relabeled space
    perm = np.asarray(pg.perm)
    src_new = perm[np.asarray(g.src)[: g.n_real_edge]]
    dst_new = perm[np.asarray(g.dst)[: g.n_real_edge]]
    w = np.asarray(g.edge_weight)[: g.n_real_edge]
    expect = np.asarray(
        spmm_coo(jnp.asarray(src_new), jnp.asarray(dst_new), x, pg.n_node, jnp.asarray(w))
    )
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_gp_full_graph_gcn_trains(g):
    """2-layer GCN over the partitioned graph: loss decreases, grads flow via collectives."""
    mesh = make_mesh(("data",))
    pg = partition_graph(g, mesh.devices.size)
    pgs = shard_partitioned_graph(pg, mesh)
    spmm = make_sharded_spmm(mesh, pgs)

    d_in, hidden, n_class = 16, 32, 4
    rng = np.random.default_rng(0)
    params = {
        "w1": jnp.asarray(rng.normal(0, 0.1, (d_in, hidden)).astype(np.float32)),
        "w2": jnp.asarray(rng.normal(0, 0.1, (hidden, n_class)).astype(np.float32)),
    }
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    x = pg.node_feat
    labels = pg.labels
    mask = pg.train_mask

    @jax.jit
    def step(params, opt_state):
        def loss_of(p):
            h = jax.nn.relu(spmm(x @ p["w1"]))
            logp = jax.nn.log_softmax(spmm(h @ p["w2"]))
            return masked_nll_loss(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state2 = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]


def test_dp_minibatch_step_runs_and_learns(g):
    mesh = make_mesh(("data",))
    D = mesh.devices.size
    sampler = NeighborSampler([4, 4], seed=0)
    hg = HostGraph.from_graph(g)
    loader = ShardedDataLoader(hg, np.arange(g.n_real_node), sampler, per_device_batch=8,
                               n_shard=D, seed=0)

    model = GraphSAGE(hidden=16, n_class=4, dropout=0.0)

    def model_apply(params, blocks, x, rng):
        return model.apply({"params": params}, blocks, x, deterministic=True)

    # init params from one local batch
    outs, blocks = next(iter(loader))
    local_blocks = jax.tree.map(lambda a: a[0], blocks,
                                is_leaf=lambda a: isinstance(a, jax.Array))
    x0 = jnp.take(g.node_feat, local_blocks[0].src_ids, axis=0)
    params = model.init(jax.random.key(0), local_blocks, x0)["params"]
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step = make_dp_block_step(mesh, model_apply, tx)

    feats, labels = g.node_feat, g.labels
    losses = []
    for epoch in range(6):
        for outs, blocks in loader:
            x = jnp.stack(
                [jnp.take(feats, blocks[0].src_ids[d], axis=0) for d in range(D)]
            )
            y = jnp.stack([jnp.take(labels, blocks[-1].dst_ids[d], axis=0) for d in range(D)])
            m = blocks[-1].dst_mask
            params, opt_state, loss = step(params, opt_state, blocks, x, y, m,
                                           jax.random.key(epoch))
            losses.append(float(loss))
    assert losses[-1] < losses[0], (losses[0], losses[-1])


@pytest.mark.parametrize("strategy", ["contiguous", "bfs"])
def test_halo_spmm_matches_allgather(g, strategy):
    from dgll_tpu.parallel.halo import build_halo_plan, make_halo_spmm

    mesh = make_mesh(("data",))
    pg = partition_graph(g, mesh.devices.size, strategy=strategy)
    pgs = shard_partitioned_graph(pg, mesh)
    plan = build_halo_plan(pg)
    # halo volume is a strict subset of the full matrix
    assert plan.halo_size < pg.rows_per_shard * mesh.devices.size

    spmm_ref = make_sharded_spmm(mesh, pgs)
    spmm_halo = make_halo_spmm(mesh, pgs, plan)
    x = pg.node_feat
    out_ref = np.asarray(spmm_ref(x))
    out_halo = np.asarray(spmm_halo(x))
    np.testing.assert_allclose(out_halo, out_ref, rtol=1e-4, atol=1e-5)


def test_halo_spmm_grad_flows(g):
    from dgll_tpu.parallel.halo import build_halo_plan, make_halo_spmm

    mesh = make_mesh(("data",))
    pg = partition_graph(g, mesh.devices.size)
    pgs = shard_partitioned_graph(pg, mesh)
    plan = build_halo_plan(pg)
    spmm_halo = make_halo_spmm(mesh, pgs, plan)

    def loss(x):
        return jnp.sum(spmm_halo(x) ** 2)

    gx = jax.grad(loss)(pg.node_feat)
    assert np.isfinite(np.asarray(gx)).all()
    # reference grad via dense formulation in the relabeled space
    perm = np.asarray(pg.perm)
    src_new = perm[np.asarray(g.src)[: g.n_real_edge]]
    dst_new = perm[np.asarray(g.dst)[: g.n_real_edge]]
    w = np.asarray(g.edge_weight)[: g.n_real_edge]

    def ref_loss(x):
        out = spmm_coo(jnp.asarray(src_new), jnp.asarray(dst_new), x, pg.n_node,
                       jnp.asarray(w))
        return jnp.sum(out ** 2)

    gr = jax.grad(ref_loss)(jnp.asarray(pg.node_feat))
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gr), rtol=1e-3, atol=1e-4)


def test_async_dp_step_matches_sync_with_one_step_lag(g):
    """RaCoM parity (VERDICT r1 #6): the async step applies step k-1's gradients at
    step k, so feeding it the SAME batch repeatedly must reproduce the sync step's
    parameter trajectory shifted by exactly one step (staleness bound == 1)."""
    from dgll_tpu.parallel.dp import make_async_dp_block_step

    mesh = make_mesh(("data",))
    D = mesh.devices.size
    sampler = NeighborSampler([4, 4], seed=0)
    hg = HostGraph.from_graph(g)
    loader = ShardedDataLoader(hg, np.arange(g.n_real_node), sampler, per_device_batch=8,
                               n_shard=D, seed=0)
    model = GraphSAGE(hidden=16, n_class=4, dropout=0.0)

    def model_apply(params, blocks, x, rng):
        return model.apply({"params": params}, blocks, x, deterministic=True)

    outs, blocks = next(iter(loader))
    local_blocks = jax.tree.map(lambda a: a[0], blocks,
                                is_leaf=lambda a: isinstance(a, jax.Array))
    x0 = jnp.take(g.node_feat, local_blocks[0].src_ids, axis=0)
    params0 = model.init(jax.random.key(0), local_blocks, x0)["params"]
    tx = optax.sgd(1e-2)  # stateless-ish optimizer makes the shift exact

    x = jnp.stack([jnp.take(g.node_feat, blocks[0].src_ids[d], axis=0) for d in range(D)])
    y = jnp.stack([jnp.take(g.labels, blocks[-1].dst_ids[d], axis=0) for d in range(D)])
    m = blocks[-1].dst_mask
    rng = jax.random.key(1)

    sync_step = make_dp_block_step(mesh, model_apply, tx)
    p_sync = jax.tree.map(jnp.copy, params0)
    s_sync = tx.init(p_sync)
    sync_losses = []
    for k in range(4):
        p_sync, s_sync, loss = sync_step(p_sync, s_sync, blocks, x, y, m, rng)
        sync_losses.append(float(loss))

    async_step, init_grads = make_async_dp_block_step(mesh, model_apply, tx)
    p_async = jax.tree.map(jnp.copy, params0)
    s_async = tx.init(p_async)
    grads = init_grads(p_async)
    async_losses = []
    for k in range(5):
        p_async, s_async, grads, loss = async_step(p_async, s_async, grads, blocks,
                                                   x, y, m, rng)
        async_losses.append(float(loss))

    # With the SAME batch every step the async schedule is exactly the sync
    # trajectory: prev_grads at step k is g(p_k) for the identical batch, so
    # p_{k+1} matches and the staleness is invisible — the strongest possible
    # parity check (any off-by-one in the gradient plumbing breaks it).
    np.testing.assert_allclose(async_losses[:4], sync_losses, rtol=1e-4, atol=1e-5)
    # and staleness is bounded at 1: the loss at step k is evaluated on params
    # that have absorbed exactly k-1 gradient applications
    assert async_losses[0] == sync_losses[0]


def test_async_dp_learns_on_fresh_batches(g):
    from dgll_tpu.parallel.dp import make_async_dp_block_step

    mesh = make_mesh(("data",))
    D = mesh.devices.size
    sampler = NeighborSampler([4, 4], seed=0)
    hg = HostGraph.from_graph(g)
    loader = ShardedDataLoader(hg, np.arange(g.n_real_node), sampler, per_device_batch=8,
                               n_shard=D, seed=0)
    model = GraphSAGE(hidden=16, n_class=4, dropout=0.0)

    def model_apply(params, blocks, x, rng):
        return model.apply({"params": params}, blocks, x, deterministic=True)

    outs, blocks = next(iter(loader))
    local_blocks = jax.tree.map(lambda a: a[0], blocks,
                                is_leaf=lambda a: isinstance(a, jax.Array))
    x0 = jnp.take(g.node_feat, local_blocks[0].src_ids, axis=0)
    params = model.init(jax.random.key(0), local_blocks, x0)["params"]
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step, init_grads = make_async_dp_block_step(mesh, model_apply, tx)
    grads = init_grads(params)

    losses = []
    for epoch in range(6):
        for outs, blocks in loader:
            x = jnp.stack([jnp.take(g.node_feat, blocks[0].src_ids[d], axis=0)
                           for d in range(D)])
            y = jnp.stack([jnp.take(g.labels, blocks[-1].dst_ids[d], axis=0)
                           for d in range(D)])
            m = blocks[-1].dst_mask
            params, opt_state, grads, loss = step(params, opt_state, grads, blocks,
                                                  x, y, m, jax.random.key(epoch))
            losses.append(float(loss))
    assert losses[-1] < losses[0], (losses[0], losses[-1])


def test_feature_sharded_spmm_matches_single_device(g):
    """TP-analog: feature-dim sharded SpMM is zero-comm and exact."""
    from dgll_tpu.parallel import make_feature_sharded_spmm, shard_features

    mesh = make_mesh(("model",))
    n = g.n_real_node
    src = np.asarray(g.src)[: g.n_real_edge]
    dst = np.asarray(g.dst)[: g.n_real_edge]
    w = np.asarray(g.edge_weight)[: g.n_real_edge]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 32)).astype(np.float32)  # 32 % 8 devices == 0 -> 4/dev
    spmm = make_feature_sharded_spmm(mesh, src, dst, w, n, axis="model")
    out = np.asarray(spmm(shard_features(mesh, jnp.asarray(x), "model")))
    expect = np.asarray(spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x),
                                 n, jnp.asarray(w)))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_tp_gcn_forward_matches_replicated(g):
    """Column->row parallel 2-layer GCN == the replicated computation (one psum)."""
    from dgll_tpu.parallel import init_tp_gcn_params, make_tp_gcn_apply

    mesh = make_mesh(("model",))
    n = g.n_real_node
    src = np.asarray(g.src)[: g.n_real_edge]
    dst = np.asarray(g.dst)[: g.n_real_edge]
    w = np.asarray(g.edge_weight)[: g.n_real_edge]
    x = np.asarray(g.node_feat)[:n]

    params = init_tp_gcn_params(mesh, x.shape[1], hidden=32, n_class=4, seed=0)
    apply_tp = make_tp_gcn_apply(mesh, src, dst, w, n)
    out = np.asarray(jax.jit(apply_tp)(params, jnp.asarray(x)))

    w1 = np.asarray(params["w1"])
    w2 = np.asarray(params["w2"])
    b2 = np.asarray(params["b2"])
    agg = lambda h: np.asarray(spmm_coo(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(h), n, jnp.asarray(w)))
    h = np.maximum(agg(x @ w1), 0)
    logits = agg(h) @ w2 + b2
    expect = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    np.testing.assert_allclose(out, expect, rtol=2e-4, atol=2e-5)


def test_halo_beats_allgather_volume_on_clustered_graph():
    """On a low-cut, id-ordered (COG-style) graph with the 'range' partition
    strategy, the halo plan's comm volume is a tiny fraction of all_gather's,
    and the auto strategy picks halo (VERDICT r2 #7)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from scaling_bench import clustered_graph

    from dgll_tpu.parallel import partition_graph
    from dgll_tpu.parallel.halo import (
        allgather_volume_bytes,
        build_halo_plan,
        halo_volume_bytes,
        make_partitioned_spmm,
    )
    from dgll_tpu.parallel import make_mesh
    import jax

    g = clustered_graph(8000, 8, 16, n_cluster=8, seed=1)
    pg = partition_graph(g, 4, strategy="range")
    plan = build_halo_plan(pg)
    hv = halo_volume_bytes(pg, plan, 16)
    av = allgather_volume_bytes(pg, 16)
    assert hv < av / 10, (hv, av)

    mesh = make_mesh(("data",), devices=jax.devices()[:4])
    _, strategy = make_partitioned_spmm(mesh, pg, 16, strategy="auto")
    assert strategy == "halo"

    # and the round-robin 'contiguous' strategy on the same graph destroys
    # locality -> auto falls back to allgather (both behaviours matter)
    pg2 = partition_graph(g, 4, strategy="contiguous")
    _, strategy2 = make_partitioned_spmm(mesh, pg2, 16, strategy="auto")
    assert strategy2 == "allgather"


def test_range_partition_spmm_matches_oracle():
    """'range' partitioning preserves SpMM exactness like the other strategies."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from scaling_bench import clustered_graph

    import jax
    import jax.numpy as jnp
    from dgll_tpu.ops import spmm_coo
    from dgll_tpu.parallel import (
        build_halo_plan, make_halo_spmm, make_mesh, partition_graph,
        shard_partitioned_graph,
    )

    g = clustered_graph(2000, 6, 8, n_cluster=4, seed=2)
    D = 4
    mesh = make_mesh(("data",), devices=jax.devices()[:D])
    pg = partition_graph(g, D, strategy="range")
    pgs = shard_partitioned_graph(pg, mesh)
    plan = build_halo_plan(pg)
    spmm = make_halo_spmm(mesh, pgs, plan)
    out = np.asarray(spmm(pgs.node_feat))

    # oracle on the relabeled graph
    perm = np.asarray(pg.perm)
    x = np.zeros((pg.n_node, 8), np.float32)
    x[perm] = np.asarray(g.node_feat)[: g.n_real_node]
    src = perm[np.asarray(g.src)[: g.n_real_edge]]
    dst = perm[np.asarray(g.dst)[: g.n_real_edge]]
    w = np.asarray(g.edge_weight)[: g.n_real_edge]
    expect = np.asarray(spmm_coo(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(x), pg.n_node, jnp.asarray(w)))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)
