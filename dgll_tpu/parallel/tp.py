"""Tensor-parallel (feature-dimension) sharding for GNN layers — the TP analog
from SURVEY.md §2.7 (no counterpart exists in the reference; a stretch goal).

Key structural fact: SpMM aggregation ``out[i] = sum w_e x[src_e]`` is
*independent per feature column*, so sharding the feature dimension over the
mesh makes the aggregation **zero-communication** — each device aggregates its
own feature slice. Matmuls then follow the Megatron MLP pattern: a
column-parallel weight produces feature-sharded activations, a row-parallel
weight contracts the sharded dimension with ONE ``psum``. A 2-layer GCN
therefore needs exactly one collective per forward.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_features(mesh: Mesh, x: jax.Array, axis: str = "model") -> jax.Array:
    """Place ``x [N, F]`` feature-sharded over the mesh axis (F % devices == 0)."""
    return jax.device_put(x, NamedSharding(mesh, P(None, axis)))


def replicate(mesh: Mesh, x) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def make_feature_sharded_spmm(mesh: Mesh, src, dst, weight, n_dst: int,
                              axis: str = "model") -> Callable:
    """Zero-communication SpMM over feature shards: every device owns F/D columns
    of x and aggregates them independently (edges replicated)."""
    src = replicate(mesh, jnp.asarray(src))
    dst = replicate(mesh, jnp.asarray(dst))
    w = None if weight is None else replicate(mesh, jnp.asarray(weight))

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(), P()) + ((P(),) if w is not None else ()),
        out_specs=P(None, axis),
    )
    def spmm(x_shard, s, d, *wt):
        msg = jnp.take(x_shard, s, axis=0)
        if wt:
            msg = msg * wt[0][:, None].astype(msg.dtype)
        return jax.ops.segment_sum(msg, d, num_segments=n_dst)

    if w is not None:
        return lambda x: spmm(x, src, dst, w)
    return lambda x: spmm(x, src, dst)


def make_tp_gcn_apply(mesh: Mesh, src, dst, weight, n_node: int,
                      axis: str = "model") -> Callable:
    """2-layer tensor-parallel GCN forward: ``log_softmax(A relu(A X W1) W2 + b)``.

    ``W1 [F, H]`` is column-parallel (output dim sharded -> activations sharded),
    ``W2 [H, C]`` row-parallel (input dim sharded -> one ``psum``); both SpMMs run
    on feature shards with no communication. Exactly ONE collective per forward.
    """
    src_r = replicate(mesh, jnp.asarray(src))
    dst_r = replicate(mesh, jnp.asarray(dst))
    w_r = replicate(mesh, jnp.asarray(weight))

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(None, axis), P(axis, None), P(), P(), P(), P()),
        out_specs=P(),
    )
    def fwd(x, w1_col, w2_row, b2, s, d, wt):
        def spmm(h):
            msg = jnp.take(h, s, axis=0) * wt[:, None].astype(h.dtype)
            return jax.ops.segment_sum(msg, d, num_segments=n_node)

        h = jax.nn.relu(spmm(x @ w1_col))        # [N, H/D] sharded activations
        logits_part = spmm(h) @ w2_row           # partial [N, C]
        logits = jax.lax.psum(logits_part, axis) + b2  # the one collective
        return jax.nn.log_softmax(logits)

    def apply(params, x):
        return fwd(x, params["w1"], params["w2"], params["b2"], src_r, dst_r, w_r)

    return apply


def init_tp_gcn_params(mesh: Mesh, f_in: int, hidden: int, n_class: int,
                       seed: int = 0, axis: str = "model") -> dict:
    """W1 sharded on the output (column) dim, W2 on the input (row) dim."""
    d = mesh.shape[axis]  # size of the named axis, not the whole mesh
    assert hidden % d == 0, f"hidden {hidden} must split over {d} devices"
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(0, np.sqrt(2.0 / f_in), (f_in, hidden))).astype(np.float32)
    w2 = (rng.normal(0, np.sqrt(2.0 / hidden), (hidden, n_class))).astype(np.float32)
    b2 = np.zeros((n_class,), np.float32)
    return {
        "w1": jax.device_put(w1, NamedSharding(mesh, P(None, axis))),
        "w2": jax.device_put(w2, NamedSharding(mesh, P(axis, None))),
        "b2": jax.device_put(b2, NamedSharding(mesh, P())),
    }
