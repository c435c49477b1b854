"""Graph convolution layers — the reference layer zoo over sparse message passing.

Parity targets (``/root/reference/dgll/nn/Convolution/``):

* ``GCNConv``  — ``gcnconv.py:29-35`` / ``gcn.py:17-48`` (``A_hat @ (X W) + b``)
* ``GATConv``  — ``gatconv.py:30-54`` dense path and ``sparseGatConv:111-148`` sparse path,
  unified here as SDDMM scores -> segment softmax -> weighted SpMM (multi-head).
* ``SAGEConv`` — ``sageconv.py:32-83`` (neighbour mean/sum/max aggregate + self transform,
  sum or concat combine).
* ``GINConv``  — ``ginconv.py:16-30`` (``ReLU(Linear(X + (1+eps) A X))``).

All layers consume a *message structure* ``g`` exposing ``src``, ``dst``, ``n_dst``
(and optionally ``edge_weight``): either a full ``dgll_tpu.graph.Graph`` or a sampled
bipartite ``dgll_tpu.sampling.Block``. The bipartite convention is DGL-style: the first
``n_dst`` source rows of ``x`` are the destination nodes themselves.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from dgll_tpu.nn.module import Dense, Dropout, Module
from dgll_tpu.ops.segment import segment_softmax
from dgll_tpu.ops.spmm import block_aggregate, spmm_coo, spmm_max_coo, spmm_mean_coo


def _is_dense_block(g) -> bool:
    """Fanout-dense sampled Block: aggregation becomes a reshape-reduce (no scatter)."""
    return getattr(g, "neigh_mask", None) is not None and getattr(g, "fanout", 0) > 0


def _n_dst(g) -> int:
    return g.n_dst if hasattr(g, "n_dst") else g.n_node


def _edge_weight(g):
    return getattr(g, "edge_weight", None)


def _require_self_at_head(g, layer: str) -> None:
    """Layers that read ``x[:n_dst]`` as the destinations' own features must reject
    blocks violating the protocol (pure importance-sampled ``SparseBlock``s built with
    ``include_seeds=False`` do not carry self features)."""
    if not getattr(g, "self_at_head", True):
        raise ValueError(
            f"{layer} needs self features (source slot i < n_dst must be destination "
            "i itself); this block was sampled with include_seeds=False. Use GCNConv, "
            "or sample with include_seeds=True."
        )


def _is_weighted_block(g) -> bool:
    """Fixed-K weighted block (device layer-wise samplers): dense gather+einsum."""
    return getattr(g, "slot", None) is not None


def _weighted_aggregate(g, h: jax.Array, n_dst: int) -> jax.Array:
    """Weighted-sum aggregation: dense gather+einsum for fixed-K weighted blocks,
    a reshape-reduce for fanout-dense blocks, the COO segment path otherwise."""
    if _is_weighted_block(g):
        rows = jnp.take(h, g.slot.reshape(-1), axis=0).reshape(n_dst, g.k, -1)
        return jnp.einsum("nk,nkf->nf", g.weight.astype(h.dtype), rows)
    if _is_dense_block(g):
        return block_aggregate(h, n_dst, g.fanout, g.neigh_mask, "sum")
    return spmm_coo(g.src, g.dst, h, n_dst, _edge_weight(g))


class GCNConv(Module):
    """``out = A_hat @ (X W) + b`` — transform-then-aggregate (W first keeps the SpMM
    operand at the smaller hidden width, same trick as the reference CUDA kernel)."""

    features: int
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x: jax.Array) -> jax.Array:
        h = Dense(self.features, use_bias=False, dtype=self.dtype, name="weight")(x)
        out = _weighted_aggregate(g, h, _n_dst(g))
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros, (self.features,), jnp.float32)
            out = out + bias.astype(out.dtype)
        return out


class GATConv(Module):
    """Multi-head graph attention.

    Scores: ``e_k = LeakyReLU(a_dst . h[dst_k] + a_src . h[src_k])`` (the additive form
    the reference builds densely at ``gatconv.py:45-54``), normalised per destination by
    ``segment_softmax`` (sparse twin of the masked dense softmax at ``gatconv.py:36-39``),
    then a per-head weighted SpMM. The projection is one matmul of width heads*features.
    """

    features: int
    num_heads: int = 1
    concat_heads: bool = True
    negative_slope: float = 0.2
    attn_dropout: float = 0.0
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x: jax.Array, deterministic: bool = True) -> jax.Array:
        H, F = self.num_heads, self.features
        n_dst = _n_dst(g)
        _require_self_at_head(g, "GATConv")
        h = Dense(H * F, use_bias=False, dtype=self.dtype, name="weight")(x)
        h = h.reshape(x.shape[0], H, F)

        a_src = self.param("attn_src", jax.nn.initializers.glorot_uniform(), (H, F), jnp.float32)
        a_dst = self.param("attn_dst", jax.nn.initializers.glorot_uniform(), (H, F), jnp.float32)

        # per-node score halves, then gather to edges (cheaper than per-edge dots)
        s_src = jnp.einsum("nhf,hf->nh", h, a_src.astype(h.dtype))
        s_dst = jnp.einsum("nhf,hf->nh", h, a_dst.astype(h.dtype))

        if _is_dense_block(g):
            # fanout-dense attention: softmax over the fanout axis, no segment ops
            fo = g.fanout
            neigh_h = jax.lax.dynamic_slice_in_dim(h, n_dst, n_dst * fo, axis=0)
            neigh_h = neigh_h.reshape(n_dst, fo, H, F)
            s_n = jax.lax.dynamic_slice_in_dim(s_src, n_dst, n_dst * fo, axis=0)
            s_n = s_n.reshape(n_dst, fo, H)
            e = jax.nn.leaky_relu(s_dst[:n_dst, None, :] + s_n, self.negative_slope)
            m = g.neigh_mask[..., None]
            e = jnp.where(m, e, -1e9)
            ex = jnp.exp(e - jax.lax.stop_gradient(e.max(axis=1, keepdims=True))) * m
            alpha = ex / jnp.maximum(ex.sum(axis=1, keepdims=True), 1e-9)
            if self.attn_dropout > 0.0 and not deterministic:
                alpha = Dropout(rate=self.attn_dropout, deterministic=False)(alpha)
            out = jnp.einsum("nfh,nfhd->nhd", alpha.astype(neigh_h.dtype), neigh_h)
        else:
            e = jnp.take(s_dst[:n_dst], g.dst, axis=0) + jnp.take(s_src, g.src, axis=0)
            e = jax.nn.leaky_relu(e, self.negative_slope)

            alpha = segment_softmax(e, g.dst, n_dst)  # [E, H]
            if self.attn_dropout > 0.0 and not deterministic:
                alpha = Dropout(rate=self.attn_dropout, deterministic=False)(alpha)

            # messages multiply and accumulate in f32 whatever the compute
            # dtype: a bf16 segment_sum over a hub's 10k+ edges loses
            # ~log2(deg) mantissa bits
            msg = jnp.take(h, g.src, axis=0).astype(jnp.float32) * alpha[..., None]
            out = jax.ops.segment_sum(msg, g.dst, num_segments=n_dst)
            out = out.astype(h.dtype)
        if self.concat_heads:
            return out.reshape(n_dst, H * F)
        return out.mean(axis=1)


class SAGEConv(Module):
    """GraphSAGE: aggregate neighbours (mean/sum/max) then combine with the self vector.

    ``combine='concat'`` matches the reference default (``sageConv.forward:70-83``);
    bipartite blocks use the first ``n_dst`` rows as the self features.
    """

    features: int
    aggregator: str = "mean"   # mean | sum | max
    combine: str = "concat"    # concat | sum
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x: jax.Array) -> jax.Array:
        n_dst = _n_dst(g)
        _require_self_at_head(g, "SAGEConv")
        if self.aggregator not in ("mean", "sum", "max"):
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if _is_dense_block(g):
            agg = block_aggregate(x, n_dst, g.fanout, g.neigh_mask, self.aggregator)
        elif self.aggregator == "mean":
            agg = spmm_mean_coo(g.src, g.dst, x, n_dst)
        elif self.aggregator == "sum":
            agg = spmm_coo(g.src, g.dst, x, n_dst, _edge_weight(g))
        else:
            agg = spmm_max_coo(g.src, g.dst, x, n_dst)

        h_neigh = Dense(self.features, use_bias=False, dtype=self.dtype, name="neigh")(agg)
        h_self = Dense(
            self.features, use_bias=self.use_bias, dtype=self.dtype, name="self"
        )(x[:n_dst])
        if self.combine == "concat":
            return jnp.concatenate([h_self, h_neigh], axis=-1)
        return h_self + h_neigh


class GINConv(Module):
    """GIN: ``act(MLP((1 + eps) x + A x))`` (ref ``ginconv.py:16-30`` uses eps=0, ReLU)."""

    features: int
    learn_eps: bool = False
    activation: Callable = jax.nn.relu
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x: jax.Array) -> jax.Array:
        n_dst = _n_dst(g)
        _require_self_at_head(g, "GINConv")
        agg = _weighted_aggregate(g, x, n_dst)
        eps = (
            self.param("eps", jax.nn.initializers.zeros, (), jnp.float32)
            if self.learn_eps
            else 0.0
        )
        h = (1.0 + eps) * x[:n_dst] + agg
        h = Dense(self.features, dtype=self.dtype, name="mlp")(h)
        return self.activation(h)
