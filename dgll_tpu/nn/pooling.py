"""Global graph pooling + graph batching.

Replacement for the reference's ``torch_scatter``-based pooling
(``/root/reference/dgll/nn/GlobalPooling/Pooling.py:18-115``): segment reductions over a
``graph_id`` vector, plus a ``batch_graphs`` helper that concatenates many small graphs
into one padded mega-graph (the standard JAX approach to variable-size graph batches).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.graph import Graph
from dgll_tpu.nn.module import Module
from dgll_tpu.ops.segment import segment_max, segment_mean, segment_sum


def sum_pooling(x: jax.Array, graph_id: jax.Array, n_graph: int) -> jax.Array:
    """Per-graph sum (ref ``sumPooling:18``)."""
    return segment_sum(x, graph_id, n_graph)


def mean_pooling(x: jax.Array, graph_id: jax.Array, n_graph: int) -> jax.Array:
    """Per-graph mean (ref ``meanPooling:40``)."""
    return segment_mean(x, graph_id, n_graph)


def max_pooling(x: jax.Array, graph_id: jax.Array, n_graph: int) -> jax.Array:
    """Per-graph max (ref ``maxPooling:62``)."""
    return segment_max(x, graph_id, n_graph)


_POOLERS = {"sum": sum_pooling, "mean": mean_pooling, "max": max_pooling}


class Pooling(Module):
    """Multiplex/concatenate global poolers (ref ``Pooling.forward:102-115``).

    ``kinds`` may name one pooler or several; several are concatenated feature-wise.
    """

    kinds: Tuple[str, ...] = ("sum",)

    def __call__(self, x: jax.Array, graph_id: jax.Array, n_graph: int) -> jax.Array:
        outs = [_POOLERS[k](x, graph_id, n_graph) for k in self.kinds]
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)


def batch_graphs(
    graphs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    node_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
):
    """Merge ``(src, dst, feats, label)`` tuples into one big Graph + graph_id vector.

    Returns ``(graph, graph_id [n_node_padded], labels [n_graph])``; padded nodes map to
    graph_id ``n_graph`` so poolers with ``n_graph`` segments ignore them.
    """
    from dgll_tpu.graph import pad_graph

    srcs, dsts, feats, gids, labels = [], [], [], [], []
    off = 0
    for i, (s, d, f, y) in enumerate(graphs):
        srcs.append(np.asarray(s) + off)
        dsts.append(np.asarray(d) + off)
        feats.append(f)
        gids.append(np.full(f.shape[0], i, np.int32))
        labels.append(y)
        off += f.shape[0]
    g = Graph.from_edges(
        np.concatenate(srcs),
        np.concatenate(dsts),
        off,
        node_feat=np.concatenate(feats, axis=0),
    )
    g = pad_graph(g, node_pad_multiple, edge_pad_multiple)
    graph_id = np.full(g.n_node, len(graphs), np.int32)
    graph_id[:off] = np.concatenate(gids)
    return g, jnp.asarray(graph_id), jnp.asarray(np.asarray(labels, np.int32))
