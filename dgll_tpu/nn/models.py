"""End-to-end model definitions — parity with the reference model zoo.

* ``GCN``       — 2..L-layer GCN w/ ReLU+dropout+log_softmax (ref ``gcnconv.py:41-58``).
* ``GAT``       — multi-head GAT, concat hidden heads, mean output heads
  (ref ``gatconv.py:154-199`` GAT/SpGAT unified).
* ``GraphSAGE`` — per-layer SAGEConv over full graph or per-hop sampled blocks
  (ref ``sageconv.py:86-114``).
* ``GIN``       — stacked GINConv, concatenated hidden states, global pooling readout
  (ref ``ginconv.py:33-65``).

Each model's ``__call__`` takes either a single message graph (full-batch) or a list of
bipartite blocks (minibatch, outermost hop first — the order ``DGLLNeighborSampler``
emits, ref ``dgllsampler.py:10-21``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from dgll_tpu.nn.conv import GATConv, GCNConv, GINConv, SAGEConv
from dgll_tpu.nn.module import Dense, Dropout, Module
from dgll_tpu.nn.pooling import Pooling


def _layer_inputs(g, n_layers):
    """Normalise graph-or-blocks input to a per-layer sequence."""
    if isinstance(g, (list, tuple)):
        assert len(g) == n_layers, f"need {n_layers} blocks, got {len(g)}"
        return list(g)
    return [g] * n_layers


class GCN(Module):
    hidden: int
    n_class: int
    n_layers: int = 2
    dropout: float = 0.5
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x, deterministic: bool = True) -> jax.Array:
        gs = _layer_inputs(g, self.n_layers)
        for i in range(self.n_layers - 1):
            x = jax.nn.relu(GCNConv(self.hidden, dtype=self.dtype)(gs[i], x))
            x = Dropout(self.dropout, deterministic=deterministic)(x)
        x = GCNConv(self.n_class, dtype=self.dtype)(gs[-1], x)
        return jax.nn.log_softmax(x)


class GAT(Module):
    hidden: int
    n_class: int
    num_heads: int = 8
    n_layers: int = 2
    dropout: float = 0.6
    negative_slope: float = 0.2
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x, deterministic: bool = True) -> jax.Array:
        gs = _layer_inputs(g, self.n_layers)
        for i in range(self.n_layers - 1):
            x = Dropout(self.dropout, deterministic=deterministic)(x)
            x = GATConv(
                self.hidden,
                num_heads=self.num_heads,
                concat_heads=True,
                negative_slope=self.negative_slope,
                attn_dropout=self.dropout,
                dtype=self.dtype,
            )(gs[i], x, deterministic)
            x = jax.nn.elu(x)
        x = Dropout(self.dropout, deterministic=deterministic)(x)
        x = GATConv(
            self.n_class,
            num_heads=1,
            concat_heads=False,
            negative_slope=self.negative_slope,
            dtype=self.dtype,
        )(gs[-1], x, deterministic)
        return jax.nn.log_softmax(x)


class GraphSAGE(Module):
    hidden: int
    n_class: int
    n_layers: int = 2
    aggregator: str = "mean"
    combine: str = "concat"
    dropout: float = 0.5
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x, deterministic: bool = True) -> jax.Array:
        gs = _layer_inputs(g, self.n_layers)
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            feats = self.n_class if last else self.hidden
            x = SAGEConv(
                feats, aggregator=self.aggregator, combine=self.combine, dtype=self.dtype
            )(gs[i], x)
            if not last:
                x = jax.nn.relu(x)
                x = Dropout(self.dropout, deterministic=deterministic)(x)
        if self.combine == "concat":  # concat doubles width; project final to n_class
            x = Dense(self.n_class, dtype=self.dtype, name="out_proj")(x)
        return jax.nn.log_softmax(x)


class GINNode(Module):
    """Node classification with stacked GINConv — the ``--Model GIN`` CLI path.

    (The reference uses GIN for graph classification only — that readout is the
    ``GIN`` model below; this is the natural node-level variant.)"""

    hidden: int
    n_class: int
    n_layers: int = 2
    learn_eps: bool = False
    dropout: float = 0.5
    dtype: Optional[jnp.dtype] = None

    def __call__(self, g, x, deterministic: bool = True) -> jax.Array:
        gs = _layer_inputs(g, self.n_layers)
        for i in range(self.n_layers - 1):
            x = GINConv(self.hidden, learn_eps=self.learn_eps, dtype=self.dtype)(gs[i], x)
            x = Dropout(self.dropout, deterministic=deterministic)(x)
        x = GINConv(
            self.n_class, learn_eps=self.learn_eps, activation=lambda h: h,
            dtype=self.dtype,
        )(gs[-1], x)
        return jax.nn.log_softmax(x)


class GIN(Module):
    """Graph classification: stacked GINConv; readout concatenates every layer's pooled
    representation (including raw input), matching ``GIN.forward`` (``ginconv.py:53-65``)."""

    hidden: int
    n_class: int
    n_layers: int = 3
    learn_eps: bool = False
    pooling: Tuple[str, ...] = ("sum",)
    dropout: float = 0.5
    dtype: Optional[jnp.dtype] = None

    def __call__(
        self, g, x, graph_id, n_graph: int, deterministic: bool = True
    ) -> jax.Array:
        pool = Pooling(self.pooling)
        readouts = [pool(x, graph_id, n_graph)]
        for _ in range(self.n_layers):
            x = GINConv(self.hidden, learn_eps=self.learn_eps, dtype=self.dtype)(g, x)
            readouts.append(pool(x, graph_id, n_graph))
        h = jnp.concatenate(readouts, axis=-1)
        h = Dropout(self.dropout, deterministic=deterministic)(h)
        return jax.nn.log_softmax(Dense(self.n_class, dtype=self.dtype)(h))
