"""COG — community-ordered graphs: detection, merging, contiguous relabeling.

Parity with the reference COG pipeline (``/root/reference/dgll/GPU Accelerator/
cog.py:107-254`` + ``main_cog.py``), dependency-free (label propagation instead of
igraph/leidenalg — same role: modularity-flavoured clustering):

* community detection           -> :func:`detect_communities` (label propagation)
* capacity model                -> :func:`max_community_size` (HBM budget /
  per-node feature+label bytes — ``cog.py:203-213``)
* ``merge_groups``              -> :func:`merge_groups` (``cog.py:64-77``)
* ``relabel_groups``            -> :func:`relabel_communities` (``cog.py:31-45``:
  each community becomes a contiguous id range; features/labels reordered)
* community book JSON           -> :func:`save_community_book` /
  :func:`load_community_book` (``utils.py:224-251``)
* contiguous feature slice      -> :func:`community_feature_slice`
  (``load_subteatures``, ``utils.py:257-264``)

Reordering is also the locality lever for the Pallas SpMM: community-contiguous ids
concentrate a row block's sources into few feature panels.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Tuple

import numpy as np

from dgll_tpu.graph import Graph


def detect_communities(g: Graph, max_iters: int = 20, seed: int = 0) -> np.ndarray:
    """Label propagation over the (real) edges -> community id per node.

    Hot path is the multithreaded C++ async LP (``csrc/graph_kernels.cpp``,
    ``dgll_label_propagation`` — the role of igraph/leidenalg in the reference,
    ``cog.py:218-228``); the fallback is a fully vectorised numpy half-sweep LP
    (no per-node Python loop), so reference-scale graphs stay seconds, not hours.
    """
    from dgll_tpu import native

    n = g.n_real_node
    indptr = np.asarray(g.indptr)[: n + 1].astype(np.int64).copy()
    indptr[-1] = min(indptr[-1], g.n_real_edge)
    nbrs = np.asarray(g.src)[: g.n_real_edge].astype(np.int64)
    labels = np.arange(n, dtype=np.int64)

    if not native.label_propagation_native(indptr, nbrs, n, max_iters, labels):
        # numpy fallback: synchronous mode-per-node via one lexsort per sweep;
        # only half the nodes update per sweep (random parity) to kill the
        # two-coloring oscillation synchronous LP is prone to.
        rng = np.random.default_rng(seed)
        dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        for it in range(2 * max_iters):
            lab = labels[nbrs]
            key = dst * (n + 1) + lab
            uniq, cnt = np.unique(key, return_counts=True)
            du, lu = uniq // (n + 1), uniq % (n + 1)
            order = np.lexsort((lu, -cnt, du))
            du_s, lu_s = du[order], lu[order]
            first = np.searchsorted(du_s, np.arange(n))
            has = first < len(du_s)
            safe = np.minimum(first, max(len(du_s) - 1, 0))
            valid = has & (du_s[safe] == np.arange(n))
            best = np.where(valid, lu_s[safe], labels)
            if (best == labels).all():
                break  # converged: NO node wants to change (not just this half)
            upd = rng.random(n) < 0.5
            labels = np.where(upd, best, labels)
    _, comp = np.unique(labels, return_inverse=True)
    return comp


def max_community_size(
    hbm_budget_bytes: int, feat_dim: int, feat_bytes: int = 4, label_bytes: int = 4
) -> int:
    """Largest community whose features+labels fit the budget (``cog.py:203-213``)."""
    per_node = feat_dim * feat_bytes + label_bytes
    return max(1, int(hbm_budget_bytes // per_node))


def merge_groups(part_of: np.ndarray, min_size: int) -> np.ndarray:
    """Merge communities smaller than ``min_size`` (``merge_groups:64-77``).

    Vectorised greedy binning: communities sorted by ascending size are packed
    into bins of prefix-sum width ``min_size`` (one O(C log C) pass instead of the
    old one-merge-per-scan O(C^2·n) loop); an undersized trailing bin merges into
    its predecessor."""
    ids, sizes = np.unique(part_of, return_counts=True)
    if len(ids) <= 1:
        _, comp = np.unique(part_of, return_inverse=True)
        return comp
    order = np.argsort(sizes, kind="stable")
    prefix = np.cumsum(sizes[order]) - sizes[order]
    gid_sorted = (prefix // max(min_size, 1)).astype(np.int64)
    # Prefix binning can leave interior bins undersized (a community spilling past
    # a bin edge claims the next bin's budget). Repair with a sequential greedy
    # fold over the BINS (n_bins ~ total/min_size, tiny next to C): close a bin
    # only once its accumulated size reaches min_size.
    _, gid_sorted = np.unique(gid_sorted, return_inverse=True)
    n_bins = int(gid_sorted.max()) + 1
    bin_sizes = np.bincount(gid_sorted, weights=sizes[order].astype(np.float64),
                            minlength=n_bins).astype(np.int64)
    fold = np.empty(n_bins, np.int64)
    cur, acc = 0, 0
    for b in range(n_bins):
        fold[b] = cur
        acc += int(bin_sizes[b])
        if acc >= min_size:
            cur += 1
            acc = 0
    if acc > 0 and cur > 0:  # undersized trailing remainder joins the last bin
        fold[fold == cur] = cur - 1
    gid_sorted = fold[gid_sorted]
    gid = np.empty(len(ids), np.int64)
    gid[order] = gid_sorted
    part = gid[np.searchsorted(ids, part_of)]
    _, comp = np.unique(part, return_inverse=True)
    return comp


def split_oversized(part_of: np.ndarray, max_size: int, seed: int = 0) -> np.ndarray:
    """Split communities above the capacity bound into max_size pieces."""
    part_of = part_of.copy()
    nxt = int(part_of.max()) + 1
    for cid in np.unique(part_of):
        members = np.nonzero(part_of == cid)[0]
        if len(members) <= max_size:
            continue
        for i in range(max_size, len(members), max_size):
            part_of[members[i : i + max_size]] = nxt
            nxt += 1
    _, comp = np.unique(part_of, return_inverse=True)
    return comp


def permute_graph(g: Graph, order: np.ndarray) -> Graph:
    """Relabel so new node ``i`` is old node ``order[i]`` (features/labels/
    masks/edges all permuted; edge weights preserved)."""
    from dgll_tpu import native

    n = g.n_real_node
    order = np.asarray(order, np.int64)
    new_id = np.empty(n, np.int64)
    new_id[order] = np.arange(n)

    src = native.remap(new_id, np.asarray(g.src)[: g.n_real_edge].astype(np.int64))
    dst = native.remap(new_id, np.asarray(g.dst)[: g.n_real_edge].astype(np.int64))
    ew = None if g.edge_weight is None else np.asarray(g.edge_weight)[: g.n_real_edge]

    def _perm(x):
        return None if x is None else np.asarray(x)[:n][order]

    return Graph.from_edges(
        src, dst, n,
        edge_weight=ew,
        node_feat=_perm(g.node_feat),
        labels=_perm(g.labels),
        train_mask=_perm(g.train_mask),
        val_mask=_perm(g.val_mask),
        test_mask=_perm(g.test_mask),
    )


def relabel_communities(g: Graph, part_of: np.ndarray) -> Tuple[Graph, Dict]:
    """Reorder node ids so each community is a contiguous range (``cog.py:31-45``).

    Returns the reordered Graph (features/labels/masks permuted, edges remapped)
    and the community book ``{cid: [start, end)}``.
    """
    order = np.argsort(part_of, kind="stable")  # nodes grouped by community

    ids, counts = np.unique(part_of, return_counts=True)
    starts = np.zeros(len(ids) + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    book = {int(c): [int(starts[i]), int(starts[i + 1])] for i, c in enumerate(ids)}

    return permute_graph(g, order), book


def run_cog(
    g: Graph,
    hbm_budget_bytes: int = 1 << 30,
    batch_size: int = 1024,
    seed: int = 0,
) -> Tuple[Graph, Dict, Dict[str, float]]:
    """Full COG pipeline: detect -> merge small -> split oversized -> relabel.

    Returns (reordered graph, community book, phase timings) — the reference persists
    graph + book + timing CSV (``cog.py:234-253``); use ``save_community_book`` and
    ``dgll_tpu.data.save_graph`` for the artifacts.
    """
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    part = detect_communities(g, seed=seed)
    timings["detect"] = time.perf_counter() - t0

    feat_dim = 0 if g.node_feat is None else int(np.asarray(g.node_feat).shape[1])
    cap = max_community_size(hbm_budget_bytes, max(feat_dim, 1))
    t0 = time.perf_counter()
    part = merge_groups(part, min_size=min(batch_size, g.n_real_node))
    part = split_oversized(part, max_size=cap, seed=seed)
    timings["merge_split"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    g2, book = relabel_communities(g, part)
    timings["relabel"] = time.perf_counter() - t0
    return g2, book, timings


def save_community_book(book: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in book.items()}, f)


def load_community_book(path: str) -> Dict[int, List[int]]:
    """ref ``load_community_book`` (``utils.py:247-251``)."""
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def community_feature_slice(features, book: Dict, cid: int):
    """Contiguous feature rows of one community (``load_subteatures:257-264``)."""
    lo, hi = book[cid]
    return features[lo:hi]
