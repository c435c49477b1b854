"""Multi-chip training: data-parallel minibatch + graph-partition full-graph.

Runs on any device count — on a CPU host, launch with a virtual mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_training.py

This is the single-controller replacement for the reference's ``mp.spawn`` + DDP/NCCL
launchers (``MQGCN.py:94-163``, ``FeatureCache/gcn.py``).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dgll_tpu.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu.nn import GraphSAGE
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


def main():
    D = jax.device_count()
    print(f"devices: {D}")
    g = gcn_normalize(
        synthetic_classification_graph(n_node=256 * D, avg_degree=8, n_class=4,
                                       feat_dim=16, seed=0)
    )
    mesh = make_mesh(("data",))

    # ---- data-parallel minibatch GraphSAGE ----
    sampler = NeighborSampler([4, 4], seed=0)
    hg = HostGraph.from_graph(g)
    loader = ShardedDataLoader(hg, np.arange(g.n_real_node), sampler,
                               per_device_batch=16, n_shard=D, seed=0)
    model = GraphSAGE(hidden=32, n_class=4, dropout=0.0)

    def model_apply(p, blocks, x, rng):
        return model.apply({"params": p}, blocks, x, deterministic=True)

    outs, blocks = next(iter(loader))
    local = jax.tree.map(lambda a: a[0], blocks,
                         is_leaf=lambda a: isinstance(a, jax.Array))
    x0 = jnp.take(g.node_feat, local[0].src_ids, axis=0)
    params = model.init(jax.random.key(0), local, x0)["params"]
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step = make_dp_block_step(mesh, model_apply, tx)
    for epoch in range(3):
        for outs, blocks in loader:
            x = jnp.stack([jnp.take(g.node_feat, blocks[0].src_ids[d], axis=0)
                           for d in range(D)])
            y = jnp.stack([jnp.take(g.labels, blocks[-1].dst_ids[d], axis=0)
                           for d in range(D)])
            params, opt_state, loss = step(params, opt_state, blocks, x, y,
                                           blocks[-1].dst_mask, jax.random.key(epoch))
        print(f"dp epoch {epoch} loss {float(loss):.4f}")

    # ---- graph-partition-parallel full-graph GCN ----
    pg = partition_graph(g, D)
    pgs = shard_partitioned_graph(pg, mesh)
    spmm = make_sharded_spmm(mesh, pgs)
    rng = np.random.default_rng(0)
    w1 = jnp.asarray(rng.normal(0, 0.1, (16, 32)).astype(np.float32))
    w2 = jnp.asarray(rng.normal(0, 0.1, (32, 4)).astype(np.float32))
    gp_params = {"w1": w1, "w2": w2}
    gp_opt = tx.init(gp_params)

    @jax.jit
    def gp_step(p, o):
        def loss_of(p):
            h = jax.nn.relu(spmm(pgs.node_feat @ p["w1"]))
            logp = jax.nn.log_softmax(spmm(h @ p["w2"]))
            return masked_nll_loss(logp, pgs.labels, pgs.train_mask)

        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, o2 = tx.update(grads, o)
        return optax.apply_updates(p, updates), o2, loss

    for i in range(10):
        gp_params, gp_opt, gp_loss = gp_step(gp_params, gp_opt)
    print(f"gp loss after 10 steps: {float(gp_loss):.4f}")


if __name__ == "__main__":
    main()
