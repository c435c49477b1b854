"""Sampling base structures: host-side CSR view + fixed-shape message blocks.

Re-design of the reference sampler layer
(``/root/reference/dgll/sampling/base_sampler.py:4-110``): instead of Python-list
neighbour walks producing ragged ``sugbraph`` edge lists, samplers here emit
**static-shape padded blocks** so the training step jits once and never recompiles.

Two block flavours:

* :class:`Block` — fanout-dense: every destination owns exactly ``fanout`` sampled
  source slots (with replacement; invalid slots masked and zero-weighted). The COO view
  is materialised lazily from an implicit layout, so aggregation is a dense
  gather + reduce, with no scatter.
* :class:`SparseBlock` — general bipartite sparse block with per-edge weights, used by
  the layer-wise importance samplers (FastGCN/LADIES) whose blocks are slices of the
  normalised Laplacian.

Both expose the layer protocol: ``src``, ``dst`` (local COO), ``n_dst``, ``n_src``,
``edge_weight``; source slot ``i < n_dst`` is destination ``i`` itself (DGL-style).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.graph import Graph
from dgll_tpu.utils import struct


class HostGraph:
    """Numpy CSR view of a Graph for fast host-side sampling (no device round-trips)."""

    def __init__(self, indptr: np.ndarray, src: np.ndarray, n_node: int):
        self.indptr = np.asarray(indptr, np.int64)
        self.src = np.asarray(src, np.int64)
        self.n_node = int(n_node)
        self.degrees = np.diff(self.indptr)

    @staticmethod
    def from_graph(g: Graph) -> "HostGraph":
        # use only real nodes/edges; padded edges sit at the tail by construction
        indptr = np.asarray(g.indptr)[: g.n_real_node + 1].copy()
        indptr[-1] = min(indptr[-1], g.n_real_edge)
        return HostGraph(indptr, np.asarray(g.src)[: g.n_real_edge], g.n_real_node)


@struct.dataclass
class Block:
    """Fanout-dense bipartite block.

    Layout: ``src_ids = [dst_ids | sampled.flatten()]`` with ``n_src = n_dst*(1+fanout)``;
    the j-th sampled neighbour of destination ``i`` lives at source slot
    ``n_dst + i*fanout + j``. ``neigh_mask[i, j]`` marks slots that carry a real
    neighbour; masked slots alias destination ``i`` with weight 0.
    """

    dst_ids: jax.Array      # [n_dst] int32 global ids (padded rows carry id 0, mask 0)
    src_ids: jax.Array      # [n_dst*(1+fanout)] int32 global ids
    neigh_mask: jax.Array   # [n_dst, fanout] bool
    dst_mask: jax.Array     # [n_dst] bool
    fanout: int = struct.field(pytree_node=False, default=0)
    n_dst: int = struct.field(pytree_node=False, default=0)

    @property
    def n_src(self) -> int:
        return self.n_dst * (1 + self.fanout)

    @property
    def n_edge(self) -> int:
        return self.n_dst * self.fanout

    @property
    def src(self) -> jax.Array:
        base = jnp.arange(self.n_dst * self.fanout, dtype=jnp.int32)
        return base + self.n_dst

    @property
    def dst(self) -> jax.Array:
        return jnp.repeat(
            jnp.arange(self.n_dst, dtype=jnp.int32), self.fanout, total_repeat_length=self.n_edge
        )

    @property
    def edge_weight(self) -> jax.Array:
        """Mean-normalised weights: sum-aggregating with these == sampled-neighbour mean."""
        return (self.neigh_mask.astype(jnp.float32) / float(max(self.fanout, 1))).reshape(-1)

    @property
    def num_src_nodes(self) -> int:  # reference sugbraph parity (base_sampler.py:92-104)
        return self.n_src

    @property
    def num_dst_nodes(self) -> int:
        return self.n_dst


@struct.dataclass
class SparseBlock:
    """General bipartite sparse block (layer-wise samplers): padded COO + weights."""

    dst_ids: jax.Array      # [n_dst] int32
    src_ids: jax.Array      # [n_src] int32
    src: jax.Array          # [n_edge] int32 local into src_ids
    dst: jax.Array          # [n_edge] int32 local into dst_ids
    edge_weight: jax.Array  # [n_edge] float32 (0 on padded edges)
    dst_mask: jax.Array     # [n_dst] bool
    src_mask: jax.Array     # [n_src] bool
    n_dst: int = struct.field(pytree_node=False, default=0)
    n_src: int = struct.field(pytree_node=False, default=0)
    n_edge: int = struct.field(pytree_node=False, default=0)
    # True iff source slot i < n_dst is destination i itself (the layer protocol).
    # Layers needing self features (SAGE/GIN/GAT) reject blocks where this is False
    # (pure importance-sampled blocks, ``include_seeds=False``).
    self_at_head: bool = struct.field(pytree_node=False, default=True)

    @property
    def num_src_nodes(self) -> int:
        return self.n_src

    @property
    def num_dst_nodes(self) -> int:
        return self.n_dst


@struct.dataclass
class WeightedBlock:
    """Fixed-K weighted bipartite block — the device layer-wise samplers' output.

    Each destination row owns exactly ``k`` weighted source SLOTS (``slot[i, j]``
    indexes into ``src_ids``; ``weight[i, j]`` carries the rescaled Laplacian
    value, 0 on invalid slots). Aggregation is therefore a dense gather +
    einsum — no segment/scatter ops — the dense form of FastGCN/LADIES' sparse
    ``Q @ x`` (the reference computes it as a scipy-sliced sparse matmul,
    ``GPU Accelerator/MQFastGCN.py:75-88``).

    Layer protocol: ``src_ids = [dst_ids | drawn]``, so source slot i < n_dst is
    destination i itself (``self_at_head`` always True here). The COO-view
    properties (``src``/``dst``/``edge_weight``) keep layers without a dense
    fast path working unchanged.
    """

    dst_ids: jax.Array      # [n_dst] int32 global ids
    src_ids: jax.Array      # [n_dst + s] int32 global ids (head: dst_ids)
    slot: jax.Array         # [n_dst, k] int32 local into src_ids (0 when weight 0)
    weight: jax.Array       # [n_dst, k] float32 rescaled Laplacian (0 invalid)
    dst_mask: jax.Array     # [n_dst] bool
    src_mask: jax.Array     # [n_dst + s] bool
    n_dst: int = struct.field(pytree_node=False, default=0)
    n_src: int = struct.field(pytree_node=False, default=0)
    k: int = struct.field(pytree_node=False, default=0)
    self_at_head: bool = struct.field(pytree_node=False, default=True)

    @property
    def n_edge(self) -> int:
        return self.n_dst * self.k

    @property
    def src(self) -> jax.Array:
        return self.slot.reshape(-1)

    @property
    def dst(self) -> jax.Array:
        return jnp.repeat(jnp.arange(self.n_dst, dtype=jnp.int32), self.k,
                          total_repeat_length=self.n_edge)

    @property
    def edge_weight(self) -> jax.Array:
        return self.weight.reshape(-1)

    @property
    def num_src_nodes(self) -> int:
        return self.n_src

    @property
    def num_dst_nodes(self) -> int:
        return self.n_dst


class BaseSampler:
    """Abstract sampler (parity: ``Base_sampler.sample``, ``base_sampler.py:20-28``).

    ``sample(g, seeds)`` -> ``(input_nodes, output_nodes, blocks)`` with blocks ordered
    outermost (input-side) first, as ``DGLLNeighborSampler`` emits (``dgllsampler.py:14-21``).
    """

    def sample(self, g: HostGraph, seeds: np.ndarray):
        raise NotImplementedError


def sample_neighbors_padded(
    g: HostGraph,
    dst_ids: np.ndarray,
    dst_mask: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniformly sample ``fanout`` in-neighbours per node, with replacement.

    Returns ``(sampled [n, fanout] global ids, mask [n, fanout])``. Zero-degree or
    masked rows fall back to the row's own id with mask 0. Vectorised/multithreaded
    replacement for the reference's per-node ``random.sample`` loop
    (``base_sampler.py:45-58``); uses the native C++ sampler when built.
    """
    from dgll_tpu import native

    safe_ids = np.where(dst_mask, dst_ids, 0)
    seed = int(rng.integers(0, 2**63 - 1))
    sampled, mask = native.sample_neighbors(
        g.indptr, g.src, safe_ids, dst_mask, fanout, seed
    )
    sampled = np.where(mask, sampled, dst_ids[:, None])
    return sampled.astype(np.int64), mask
