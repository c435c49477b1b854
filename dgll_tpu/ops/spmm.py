"""Sparse(A) x Dense(X) aggregation — the framework's hottest op.

Plain-XLA forms of the reference's fused CUDA GCN kernel
(``/root/reference/dgll/FusedKernel/gcn_fused_kernel.cu:5-74`` — ``ReLU(A_csr @ (X @ W))``)
and of the ``torch.spmm`` calls in its dense layers (``dgll/nn/Convolution/gcnconv.py:33``):
``spmm_coo`` gathers source rows and ``segment_sum``s them into destinations; on a GPU
XLA lowers the scatter to native atomic adds. It runs on any backend and is the
semantics every other aggregation path is tested against.

``fused_gcn_layer`` mirrors the reference's fused forward exactly (one call = normalise ->
aggregate -> transform -> bias -> ReLU) with a custom VJP matching
``gcn_fused_kernel_backward_optimized`` (``gcn_fused_kernel.cu:77-188``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp


# The COO path materialises an [E, F] message matrix; above this many bytes the
# feature dim is processed in 128-wide tiles so full-graph aggregation at scale
# (e.g. exact inference: 16M edges x 512 features = 33 GB untiled) stays inside
# device memory. Static trace-time decision — small/hot paths are untouched.
_MSG_TILE_BYTES = 2 << 30


def _msg_f_tiles(src, f: int, itemsize: int):
    if int(src.shape[0]) * f * itemsize <= _MSG_TILE_BYTES or f <= 128:
        return None
    return list(range(0, f, 128))


def spmm_coo(
    src: jax.Array,
    dst: jax.Array,
    x: jax.Array,
    n_dst: int,
    edge_weight: Optional[jax.Array] = None,
) -> jax.Array:
    """out[i] = sum_{(u -> i) in E} w_e * x[u].

    Differentiable through both ``x`` and ``edge_weight`` (XLA scatter-add
    transpose). Messages are summed in at least float32, forward and backward,
    and the result cast back to ``x.dtype``: a bfloat16 sum over a hub's 10k+
    in-edges would lose ~log2(deg) mantissa bits.
    """
    acc = jnp.promote_types(x.dtype, jnp.float32)

    def aggregate(xs):
        # convert before the gather, so its transpose (the backward's
        # scatter-add) also sums in acc
        msg = jnp.take(xs.astype(acc), src, axis=0)
        if edge_weight is not None:
            msg = msg * edge_weight[:, None].astype(acc)
        return jax.ops.segment_sum(msg, dst, num_segments=n_dst).astype(x.dtype)

    f = x.shape[-1]
    tiles = _msg_f_tiles(src, f, jnp.dtype(acc).itemsize)
    if tiles is None:
        return aggregate(x)
    return jnp.concatenate(
        [aggregate(jax.lax.slice_in_dim(x, lo, min(lo + 128, f), axis=1))
         for lo in tiles], axis=-1)


def spmm_mean_coo(src, dst, x, n_dst) -> jax.Array:
    """Mean aggregation over in-neighbours (SAGE 'mean')."""
    tot = spmm_coo(src, dst, x, n_dst)
    deg = jax.ops.segment_sum(jnp.ones_like(dst, dtype=x.dtype), dst, num_segments=n_dst)
    return tot / jnp.maximum(deg, 1)[:, None]


def spmm_max_coo(src, dst, x, n_dst) -> jax.Array:
    """Max aggregation (SAGE 'max'); empty rows give 0."""
    f = x.shape[-1]
    tiles = _msg_f_tiles(src, f, x.dtype.itemsize)
    if tiles is not None:
        outs = []
        for lo in tiles:
            xs = jax.lax.slice_in_dim(x, lo, min(lo + 128, f), axis=1)
            outs.append(jax.ops.segment_max(jnp.take(xs, src, axis=0), dst,
                                            num_segments=n_dst))
        out = jnp.concatenate(outs, axis=-1)
    else:
        msg = jnp.take(x, src, axis=0)
        out = jax.ops.segment_max(msg, dst, num_segments=n_dst)
    deg = jax.ops.segment_sum(jnp.ones_like(dst, jnp.float32), dst, num_segments=n_dst)
    return jnp.where((deg == 0)[:, None], 0.0, out)


def block_aggregate(x: jax.Array, n_dst: int, fanout: int, neigh_mask: jax.Array,
                    kind: str = "mean") -> jax.Array:
    """Fanout-dense aggregation for sampled ``Block``s — no gather, no scatter.

    A ``Block``'s source rows are laid out ``[dst | sampled.flatten()]``, so the
    sampled-neighbour slab ``x[n_dst : n_dst*(1+fanout)]`` reshapes to
    ``[n_dst, fanout, F]`` and aggregation is a masked reduce over the fanout axis —
    the dense form of the reference's ``[n, fanout, d]`` aggregation
    (``sageconv.py:32-45``). Semantics match the COO ops on Blocks exactly:

    * ``mean``: plain mean over all slots (masked slots alias the destination's own
      row by construction, like ``spmm_mean_coo`` with the Block's COO view);
    * ``sum``: mask-weighted sum / fanout (== ``spmm_coo`` with ``Block.edge_weight``);
    * ``max``: max over all slots.
    """
    f = x.shape[-1]
    neigh = jax.lax.dynamic_slice_in_dim(x, n_dst, n_dst * fanout, axis=0)
    neigh = neigh.reshape(n_dst, fanout, f)
    if kind == "mean":
        return neigh.mean(axis=1)
    if kind == "sum":
        # NOT an unnormalised neighbour sum: mask-weighted sum / fanout, matching
        # Block.edge_weight's 1/fanout mean-normalised convention (== spmm_coo
        # over the Block's COO view). Callers wanting a raw sum must rescale.
        w = neigh_mask.astype(neigh.dtype)[..., None]
        return (neigh * w).sum(axis=1) / float(max(fanout, 1))
    if kind == "max":
        return neigh.max(axis=1)
    raise ValueError(f"unknown aggregation {kind!r}")


def sddmm_coo(
    src: jax.Array,
    dst: jax.Array,
    a: jax.Array,
    b: jax.Array,
) -> jax.Array:
    """Sampled dense-dense matmul: per-edge ``e_k = <a[dst_k], b[src_k]>``.

    The building block of GAT scores; replaces the reference's dense
    ``Wh @ a1 + (Wh @ a2)^T`` trick (``gatconv.py:45-54``) with an edge-list form.
    """
    return jnp.sum(jnp.take(a, dst, axis=0) * jnp.take(b, src, axis=0), axis=-1)


@partial(jax.custom_vjp, nondiff_argnums=(5,))
def fused_gcn_layer(src, dst, edge_weight, x, w, n_dst):
    """ReLU(A @ (X @ W)) with custom VJP — semantic twin of the reference fused kernel.

    Forward matches ``gcn_extension.gcn_fused_forward`` (``gcn_extension.cpp:22-57``);
    backward computes grad_W = X^T (A^T g·mask), grad_X = (A^T g·mask) W^T like
    ``gcn_fused_kernel.cu:77-188`` (note the reference's backward omits the ReLU mask —
    a bug we do not replicate; we mask correctly).
    """
    h = x @ w
    agg = spmm_coo(src, dst, h, n_dst, edge_weight)
    return jax.nn.relu(agg)


def _fused_gcn_fwd(src, dst, edge_weight, x, w, n_dst):
    h = x @ w
    agg = spmm_coo(src, dst, h, n_dst, edge_weight)
    out = jax.nn.relu(agg)
    return out, (src, dst, edge_weight, x, w, agg > 0)


def _fused_gcn_bwd(n_dst, res, g):
    src, dst, edge_weight, x, w, relu_mask = res
    g = jnp.where(relu_mask, g, 0.0)
    # grad wrt h = A^T g : transpose aggregation (swap src/dst roles)
    gh = spmm_coo(dst, src, g, x.shape[0], edge_weight)
    gx = gh @ w.T
    gw = x.T @ gh
    return (None, None, None, gx, gw)


fused_gcn_layer.defvjp(_fused_gcn_fwd, _fused_gcn_bwd)
