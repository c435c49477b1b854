"""Device-resident graph container.

Re-design of the reference's ``DGraph`` (``/root/reference/dgll/data/dgraph.py:18-132``):
instead of a Python dict-of-adjacency-lists, a :class:`Graph` is a pytree of fixed-shape
``jax.Array``s (COO + dst-major CSR) so that every training step is a single jitted function
and the graph can be sharded over a ``jax.sharding.Mesh``.

Conventions
-----------
* Edges are stored sorted by **destination** node ("dst-major CSR"): message passing
  aggregates messages *into* the destination, so ``indptr[i]:indptr[i+1]`` spans the
  in-edges of node ``i`` and ``src[k]`` is the neighbour the message comes from.
* All shapes are static. Graphs may be padded (``pad_graph``): padded edges point from the
  node ``n_node - 1``-th *real* node range into a dummy region and carry zero weight;
  ``n_real_node`` / ``n_real_edge`` record the true counts.
* Feature/label/mask arrays ride along as optional pytree leaves.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.utils import struct


@struct.dataclass
class Graph:
    """Static-shape graph: COO + dst-major CSR, features, labels, split masks.

    Parity surface of ``DGraph`` (reference ``dgll/data/dgraph.py``): neighbour query,
    induced subgraph, feature/label/split gathers — see methods below — but held as
    device arrays, not Python lists.
    """

    # CSR over destinations: in-edges of node i are slots indptr[i]:indptr[i+1].
    indptr: jax.Array        # [n_node + 1] int32
    src: jax.Array           # [n_edge] int32 — source node of each edge (CSR order)
    dst: jax.Array           # [n_edge] int32 — destination node (sorted, non-decreasing)
    edge_weight: Optional[jax.Array] = None   # [n_edge] float32 (e.g. sym-norm A-hat)

    node_feat: Optional[jax.Array] = None     # [n_node, d]
    labels: Optional[jax.Array] = None        # [n_node] or [n_node, c]
    train_mask: Optional[jax.Array] = None    # [n_node] bool
    val_mask: Optional[jax.Array] = None      # [n_node] bool
    test_mask: Optional[jax.Array] = None     # [n_node] bool

    # Static metadata (not traced).
    n_node: int = struct.field(pytree_node=False, default=0)
    n_edge: int = struct.field(pytree_node=False, default=0)
    n_real_node: int = struct.field(pytree_node=False, default=0)
    n_real_edge: int = struct.field(pytree_node=False, default=0)

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_edges(
        src: Any,
        dst: Any,
        n_node: int,
        edge_weight: Any = None,
        node_feat: Any = None,
        labels: Any = None,
        train_mask: Any = None,
        val_mask: Any = None,
        test_mask: Any = None,
        add_self_loops: bool = False,
        make_bidirected: bool = False,
    ) -> "Graph":
        """Build a Graph from a COO edge list (host-side; sorts by dst, builds indptr)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if edge_weight is not None:
            edge_weight = np.asarray(edge_weight, dtype=np.float32)

        if make_bidirected:
            s2 = np.concatenate([src, dst])
            d2 = np.concatenate([dst, src])
            # dedupe (also removes duplicate input edges)
            key = s2 * n_node + d2
            _, keep = np.unique(key, return_index=True)
            src, dst = s2[keep], d2[keep]
            if edge_weight is not None:
                edge_weight = np.concatenate([edge_weight, edge_weight])[keep]
        if add_self_loops:
            has_loop = np.zeros(n_node, bool)
            has_loop[dst[src == dst]] = True
            loop = np.nonzero(~has_loop)[0].astype(np.int64)
            src = np.concatenate([src, loop])
            dst = np.concatenate([dst, loop])
            if edge_weight is not None:
                edge_weight = np.concatenate(
                    [edge_weight, np.ones(loop.shape[0], np.float32)]
                )

        from dgll_tpu import native

        fused = native.build_csr_apply(dst, src, edge_weight, n_node)
        if fused is not None:
            # fused C++ build+permute (no numpy fancy-gather passes)
            indptr, src, dst, edge_weight = fused
        else:
            indptr, order = native.build_csr(dst, n_node)
            src, dst = src[order], dst[order]
            if edge_weight is not None:
                edge_weight = edge_weight[order]

        n_edge = src.shape[0]
        # Leaves stay HOST numpy: graph construction/normalisation/sampling are
        # host-side; one explicit .to_device() moves everything over in a single
        # batch when training starts (device round-trips during prep are pure
        # overhead).
        return Graph(
            indptr=indptr.astype(np.int32),
            src=src.astype(np.int32),
            dst=dst.astype(np.int32),
            edge_weight=None if edge_weight is None else np.asarray(edge_weight, np.float32),
            node_feat=None if node_feat is None else np.asarray(node_feat),
            labels=None if labels is None else np.asarray(labels),
            train_mask=None if train_mask is None else np.asarray(train_mask, bool),
            val_mask=None if val_mask is None else np.asarray(val_mask, bool),
            test_mask=None if test_mask is None else np.asarray(test_mask, bool),
            n_node=int(n_node),
            n_edge=int(n_edge),
            n_real_node=int(n_node),
            n_real_edge=int(n_edge),
        )

    def to_device(self, device=None) -> "Graph":
        """Move all array leaves to device (one batched transfer)."""
        def put(x):
            if x is None:
                return None
            return jax.device_put(x, device) if device is not None else jnp.asarray(x)

        return jax.block_until_ready(jax.tree.map(put, self))

    # ------------------------------------------------------- DGraph-parity API
    # (reference dgll/data/dgraph.py:49-132; host-side conveniences, not jitted)
    def get_neighbors(self, nodes: Sequence[int]) -> list:
        """In-neighbour lists for the given nodes (ref ``DGraph.get_neighbors:49``)."""
        indptr = np.asarray(self.indptr)
        src = np.asarray(self.src)
        return [list(src[indptr[int(v)] : indptr[int(v) + 1]]) for v in nodes]

    def get_induced_subgraph(self, nodes: Sequence[int]) -> np.ndarray:
        """Dense adjacency of the induced subgraph (ref ``get_induced_subgraph:64``)."""
        nodes = np.asarray(list(nodes), dtype=np.int64)
        pos = {int(v): i for i, v in enumerate(nodes)}
        adj = np.zeros((len(nodes), len(nodes)), dtype=np.float32)
        indptr = np.asarray(self.indptr)
        src = np.asarray(self.src)
        for i, v in enumerate(nodes):
            for u in src[indptr[v] : indptr[v + 1]]:
                j = pos.get(int(u))
                if j is not None:
                    adj[i, j] = 1.0
        return adj

    def get_features(self, nodes) -> jax.Array:
        """Feature rows for nodes (ref ``get_features:95``)."""
        return jnp.take(self.node_feat, jnp.asarray(nodes, jnp.int32), axis=0)

    def get_labels(self, nodes) -> jax.Array:
        """Label rows for nodes (ref ``get_labels:83``)."""
        return jnp.take(self.labels, jnp.asarray(nodes, jnp.int32), axis=0)

    def _mask_nodes(self, mask: Optional[jax.Array]) -> np.ndarray:
        if mask is None:
            return np.zeros((0,), np.int32)
        return np.nonzero(np.asarray(mask))[0].astype(np.int32)

    def get_train_nodes(self) -> np.ndarray:
        """Train split node ids (ref ``get_train_nodes:107``)."""
        return self._mask_nodes(self.train_mask)

    def get_validation_nodes(self) -> np.ndarray:
        return self._mask_nodes(self.val_mask)

    def get_test_nodes(self) -> np.ndarray:
        return self._mask_nodes(self.test_mask)

    # ---------------------------------------------------------------- derived
    @property
    def in_degrees(self) -> jax.Array:
        return self.indptr[1:] - self.indptr[:-1]

    def out_degrees_np(self) -> np.ndarray:
        deg = np.zeros(self.n_node, dtype=np.int64)
        np.add.at(deg, np.asarray(self.src), 1)
        return deg

    @property
    def edge_mask(self) -> jax.Array:
        """Boolean mask of real (non-padding) edges."""
        e = jnp.arange(self.n_edge)
        return e < self.n_real_edge

    @property
    def node_mask(self) -> jax.Array:
        v = jnp.arange(self.n_node)
        return v < self.n_real_node

    def with_features(self, node_feat=None, labels=None) -> "Graph":
        return self.replace(
            node_feat=self.node_feat if node_feat is None else node_feat,
            labels=self.labels if labels is None else labels,
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_graph(g: Graph, node_multiple: int = 8, edge_multiple: int = 128) -> Graph:
    """Pad node/edge counts up to multiples for jit-stable shapes.

    Padded edges are self-loops on a **padded** node (never a real one), so they
    contribute nothing to any real aggregation — weighted or not. If edges need
    padding but the node count is already aligned, one extra block of padding nodes
    is added to guarantee a padded target exists; padded feature rows are zero.
    """
    pn = _round_up(max(g.n_node, 1), node_multiple)
    pe = _round_up(max(g.n_edge, 1), edge_multiple)
    if pe > g.n_edge and pn == g.n_node:
        # a padded pad-edge target must exist: never route pad edges to a real node
        # (unweighted sum/mean/max aggregation would pick up phantom self-messages)
        pn += node_multiple
    if pn == g.n_node and pe == g.n_edge:
        return g

    dn, de = pn - g.n_node, pe - g.n_edge
    indptr = np.asarray(g.indptr)
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    if dn:
        indptr = np.concatenate([indptr, np.full((dn,), g.n_edge, np.int32)])
    # route padding edges to the last padded node (guaranteed > n_real_node - 1)
    pad_target = pn - 1
    if de:
        src = np.concatenate([src, np.full((de,), pad_target, np.int32)])
        dst = np.concatenate([dst, np.full((de,), pad_target, np.int32)])
        indptr = indptr.copy()
        indptr[-1] = pe

    def _pad_rows(x, rows):
        if x is None or rows == 0:
            return x
        x = np.asarray(x)
        pad_width = [(0, rows)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width)

    ew = g.edge_weight
    if ew is not None and de:
        ew = np.concatenate([np.asarray(ew), np.zeros((de,), np.float32)])

    return g.replace(
        indptr=indptr.astype(np.int32),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        edge_weight=ew,
        node_feat=_pad_rows(g.node_feat, dn),
        labels=_pad_rows(g.labels, dn),
        train_mask=_pad_rows(g.train_mask, dn),
        val_mask=_pad_rows(g.val_mask, dn),
        test_mask=_pad_rows(g.test_mask, dn),
        n_node=pn,
        n_edge=pe,
        n_real_node=g.n_real_node,
        n_real_edge=g.n_real_edge,
    )
