"""Graph-partition-parallel full-graph training (shard_map over the mesh).

The replacement for the reference's aspirational DistGraph/graph-server
layer (README-only; SURVEY.md §0) and its shared-memory graph store: the graph lives
as sharded ``jax.Array``s on the mesh; each device owns a contiguous destination-row
shard of the CSR; remote source features arrive via XLA collectives
(all_gather v1 — halo/all-to-all optimisation lives in ``dgll_tpu/parallel/halo.py``).
Gradients sync with ``psum`` inside the same jitted step — DDP+RaCoM replaced by the
XLA latency-hiding scheduler overlapping the collective with compute.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgll_tpu.parallel.partition import PartitionedGraph
from dgll_tpu.train.metrics import masked_nll_loss


def shard_partitioned_graph(pg: PartitionedGraph, mesh: Mesh, axis: str = "data"):
    """Place shard-leading arrays on the mesh (edge arrays dim 0; node arrays dim 0
    since relabeled node ranges align with shards)."""
    edge_sh = NamedSharding(mesh, P(axis))
    node_sh = NamedSharding(mesh, P(axis))

    def put_edges(x):
        return jax.device_put(x, edge_sh)

    def put_nodes(x):
        return None if x is None else jax.device_put(x, node_sh)

    return pg.replace(
        src=put_edges(pg.src),
        dst_local=put_edges(pg.dst_local),
        edge_weight=put_edges(pg.edge_weight),
        node_feat=put_nodes(pg.node_feat),
        labels=put_nodes(pg.labels),
        train_mask=put_nodes(pg.train_mask),
        val_mask=put_nodes(pg.val_mask),
        test_mask=put_nodes(pg.test_mask),
        perm=None,
    )


def make_sharded_spmm(mesh: Mesh, pg: PartitionedGraph, axis: str = "data"):
    """Sharded out[i] = sum_e w_e x[src_e] for destination rows owned per device.

    v1 strategy: all_gather the sharded feature matrix (NCCL on GPUs), aggregate
    locally. Static shapes; one jitted function.
    """
    rows = pg.rows_per_shard

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def spmm(x_local, src, dst_local, w):
        # shard_map gives block-local views with the leading shard axis of size 1
        src, dst_local, w = src[0], dst_local[0], w[0]
        x_full = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
        msg = jnp.take(x_full, src, axis=0) * w[:, None].astype(x_full.dtype)
        return jax.ops.segment_sum(msg, dst_local, num_segments=rows)

    def apply(x):
        return spmm(x, pg.src, pg.dst_local, pg.edge_weight)

    return apply


def make_gp_gcn_train_step(
    mesh: Mesh,
    pg: PartitionedGraph,
    model_apply: Callable,
    tx: optax.GradientTransformation,
    axis: str = "data",
):
    """Full jitted training step for a partitioned full-graph model.

    ``model_apply(params, spmm_fn, x) -> log-probs`` builds the network from the
    sharded spmm; params replicate, activations shard by node range, gradients are
    implicitly summed by GSPMD through the all_gather transpose (reduce-scatter).
    """
    spmm = make_sharded_spmm(mesh, pg, axis)
    node_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, x, labels, mask, rng):
        def loss_of(p):
            logp = model_apply(p, spmm, x, rng)
            return masked_nll_loss(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    return step, node_sh, rep
