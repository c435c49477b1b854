"""Graph partitioning for multi-chip training.

Replacement for COG community reordering + partition books
(``/root/reference/dgll/GPU Accelerator/cog.py:31-45,107-254``, ``utils.py:224-251``):
nodes are relabeled so each shard owns a **contiguous id range** (so a shard's feature
rows are a dense slice — the property COG engineered for its cache), and each shard's
in-edges are padded to the same static count so the per-shard aggregation is one jitted
``shard_map`` body with no ragged shapes.

Partition strategies: ``contiguous`` (cheap, degree-balanced) and ``metis``-style BFS
grow (locality-greedy) — both host-side preprocessing, run once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.graph import Graph
from dgll_tpu.utils import struct


@struct.dataclass
class PartitionedGraph:
    """Per-shard dst-major CSR stacked on a leading shard axis.

    Shard ``k`` owns destination nodes ``[k*rows, (k+1)*rows)`` after relabeling.
    ``src`` holds *global* (relabeled) source ids; ``dst_local`` is the destination
    offset within the shard. Padded edge slots point at row 0 with weight 0.
    """

    src: jax.Array          # [n_shard, e_shard] int32 global source ids
    dst_local: jax.Array    # [n_shard, e_shard] int32 local dst offsets
    edge_weight: jax.Array  # [n_shard, e_shard] float32 (0 = padding)
    node_feat: Optional[jax.Array] = None   # [n_shard * rows, d] (relabeled order)
    labels: Optional[jax.Array] = None
    train_mask: Optional[jax.Array] = None
    val_mask: Optional[jax.Array] = None
    test_mask: Optional[jax.Array] = None
    perm: Optional[jax.Array] = None        # [n_node] old -> new id mapping
    n_shard: int = struct.field(pytree_node=False, default=1)
    rows_per_shard: int = struct.field(pytree_node=False, default=0)
    e_shard: int = struct.field(pytree_node=False, default=0)
    n_real_node: int = struct.field(pytree_node=False, default=0)

    @property
    def n_node(self) -> int:
        return self.n_shard * self.rows_per_shard


def _contiguous_assignment(g: Graph, n_parts: int) -> np.ndarray:
    """Balanced contiguous ranges over a degree-aware node order (hubs spread round-robin)."""
    deg = np.asarray(g.in_degrees)[: g.n_real_node]
    order = np.argsort(-deg, kind="stable")
    part_of = np.zeros(g.n_real_node, np.int32)
    # round-robin hubs across parts, then fill
    part_of[order] = np.arange(g.n_real_node) % n_parts
    return part_of


def _bfs_grow_assignment(g: Graph, n_parts: int, seed: int = 0) -> np.ndarray:
    """Locality-greedy BFS growth (METIS-flavoured without the dependency)."""
    n = g.n_real_node
    indptr = np.asarray(g.indptr)[: n + 1]
    src = np.asarray(g.src)[: g.n_real_edge]
    target = -(-n // n_parts)
    part_of = np.full(n, -1, np.int32)
    rng = np.random.default_rng(seed)
    from collections import deque

    sizes = np.zeros(n_parts, np.int64)
    for p in range(n_parts):
        # seed at an unassigned node
        unass = np.nonzero(part_of < 0)[0]
        if unass.size == 0:
            break
        q = deque([int(rng.choice(unass))])
        while q and sizes[p] < target:
            v = q.popleft()
            if part_of[v] >= 0:
                continue
            part_of[v] = p
            sizes[p] += 1
            for u in src[indptr[v] : indptr[v + 1]]:
                if part_of[u] < 0:
                    q.append(int(u))
    # leftovers
    for v in np.nonzero(part_of < 0)[0]:
        part_of[v] = int(np.argmin(sizes))
        sizes[part_of[v]] += 1
    return part_of


def partition_graph(
    g: Graph,
    n_parts: int,
    strategy: str = "contiguous",
    edge_multiple: int = 128,
    seed: int = 0,
) -> PartitionedGraph:
    """Partition destinations into ``n_parts`` shards with contiguous relabeling."""
    n = g.n_real_node
    if strategy == "contiguous":
        part_of = _contiguous_assignment(g, n_parts)
    elif strategy == "bfs":
        part_of = _bfs_grow_assignment(g, n_parts, seed)
    elif strategy == "range":
        # preserve the existing id order: shard = id // rows. The right choice
        # when ids are already locality-ordered (COG-relabeled communities,
        # pre-clustered datasets) — cut-proportional halo volume depends on it.
        part_of = (np.arange(n) // -(-n // n_parts)).astype(np.int32)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    # relabel: nodes of part 0 first, etc.; pad each part to equal rows
    # (vectorised: new id = part * rows + rank within part, stable order)
    rows = -(-n // n_parts)
    order = np.argsort(part_of, kind="stable")
    sorted_parts = part_of[order].astype(np.int64)
    starts = np.searchsorted(sorted_parts, np.arange(n_parts))
    within = np.arange(n, dtype=np.int64) - starts[sorted_parts]
    new_id = np.empty(n, np.int64)
    new_id[order] = sorted_parts * rows + within

    from dgll_tpu import native

    src = native.remap(new_id, np.asarray(g.src)[: g.n_real_edge])
    dst = native.remap(new_id, np.asarray(g.dst)[: g.n_real_edge])
    w = (
        np.asarray(g.edge_weight)[: g.n_real_edge]
        if g.edge_weight is not None
        else np.ones(g.n_real_edge, np.float32)
    )

    counts = np.bincount(dst // rows, minlength=n_parts)
    e_shard = int(counts.max()) if len(counts) else 0
    e_shard = ((e_shard + edge_multiple - 1) // edge_multiple) * edge_multiple

    from dgll_tpu import native

    packed = native.partition_pack(src, dst, w, rows, n_parts, e_shard)
    if packed is not None:
        S, D, W = packed
    else:
        # numpy fallback: counting sort by shard, then one flat scatter
        shard = dst // rows
        within = np.empty(len(shard), np.int64)
        for p in range(n_parts):
            m = shard == p
            within[m] = np.arange(int(counts[p]), dtype=np.int64)
        flat = shard * e_shard + within
        S = np.zeros(n_parts * e_shard, np.int32)
        D = np.zeros(n_parts * e_shard, np.int32)
        W = np.zeros(n_parts * e_shard, np.float32)
        S[flat] = src
        D[flat] = dst - shard * rows
        W[flat] = w
        S, D, W = (a.reshape(n_parts, e_shard) for a in (S, D, W))

    def _reorder(x):
        if x is None:
            return None
        xp = np.asarray(x)[:n]
        out = np.zeros((n_parts * rows,) + xp.shape[1:], xp.dtype)
        out[new_id] = xp
        return out  # host numpy; shard_partitioned_graph places on the mesh

    return PartitionedGraph(
        src=S,
        dst_local=D,
        edge_weight=W,
        node_feat=_reorder(g.node_feat),
        labels=_reorder(g.labels),
        train_mask=_reorder(g.train_mask),
        val_mask=_reorder(g.val_mask),
        test_mask=_reorder(g.test_mask),
        perm=new_id.astype(np.int32),
        n_shard=n_parts,
        rows_per_shard=rows,
        e_shard=e_shard,
        n_real_node=n,
    )
