"""Device-resident layer-wise importance sampling: FastGCN / LADIES inside jit.

The reference's best published number (ogbn-products 6.12 ms/batch,
``/root/reference/README.md:45``) comes from its layer-wise samplers
(``GPU Accelerator/MQFastGCN.py:60-88``, ``MQLadies.py:62-89``) running as host
numpy inside the queue pipeline. Here the whole draw runs inside the jitted
epoch program, so layer-wise sampling composes with the single-dispatch scanned
epoch (``train/device_pipeline.py``) the same way uniform neighbour sampling
already does — zero per-batch host work.

Design (all static shapes):

* The normalised Laplacian lives in HBM in **ELL layout** ``[N, K]`` (columns +
  values), each row pre-sorted by |value| descending at build time, so the
  K-truncation keeps the heaviest entries — the same importance-weighted
  truncation the host packer applies (``layerwise.py:_pack_sparse_block``).
* **FastGCN** draws each layer's ``s`` candidates from the fixed global
  distribution ``p_i ∝ ||L[:, i]||²`` via a precomputed **alias table** — two
  packed-table lookups per draw, O(s) per layer.
* **LADIES** draws ``s`` candidate *edges* from the previous layer's gathered
  ELL windows with probability ∝ L², by inverse-CDF over the flattened window
  grid. Drawing edges and keeping their columns reproduces the exact LADIES
  column marginal ``p_j ∝ Σ_{i∈prev} L²[i, j]`` without ever materialising a
  length-N probability vector on device.
* Draws are **with replacement** (the jit-friendly form); drawn-only columns
  are rescaled by ``mult/(s·p_j)`` (the textbook unbiased FastGCN estimator),
  while previous-layer columns — included deterministically — keep their exact
  Laplacian weight (*defensive* importance sampling: unbiased AND bounded; the
  naive everything-rescaled form amplifies exact columns by 1/(s·p_j) and is
  what the reference's code computes-then-discards, see ``_layer``). The host
  samplers use the same weighting — agreement tested in
  ``tests/test_device_layerwise.py``.
* Blocks are :class:`~dgll_tpu.sampling.base.WeightedBlock`: every destination
  keeps its K window slots, each mapped to a source slot of
  ``src_ids = [prev | drawn]`` (first match wins, so previous-layer columns are
  preferred — mirroring the reference's appending of batch nodes to the sampled
  set, ``MQFastGCN.py:81-84``) with weight ``L_ij · mult / (s · p_j)``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.sampling.base import WeightedBlock
from dgll_tpu.sampling.device_sampler import pack_1d, take_packed
from dgll_tpu.utils import struct


@struct.dataclass
class DeviceLap:
    """HBM-resident normalised-Laplacian view for device layer-wise sampling."""

    ell_col: jax.Array      # [N, K] int32 (-1 on padding)
    ell_val: jax.Array      # [N, K] float32 Laplacian values (0 on padding)
    p_packed: jax.Array     # pack_1d(pfull) [*, LANE] f32 — FastGCN column probs
    alias_prob_p: jax.Array  # pack_1d alias acceptance probabilities
    alias_idx_p: jax.Array   # pack_1d alias fallback indices
    n_node: int = struct.field(pytree_node=False, default=0)
    k: int = struct.field(pytree_node=False, default=0)


def build_alias_table(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias table for O(1) categorical draws. Returns (prob, alias)."""
    p = np.asarray(p, np.float64)
    n = len(p)
    tot = p.sum()
    if tot <= 0:
        p = np.ones(n)
        tot = float(n)
    scaled = p * (n / tot)
    prob = np.ones(n)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int64)


def build_device_lap(g, k: int = 32, flatten: bool = False) -> DeviceLap:
    """Pack ``D^-1/2 (A+I) D^-1/2`` into the device ELL layout (host, numpy).

    ``flatten`` bakes the ``p <- sqrt(p)`` FastGCN ``+flat`` variant
    (``MQFastGCNFlat.py:78``) into the alias table and probability table.
    """
    from dgll_tpu.sampling.layerwise import normalized_laplacian

    lap = normalized_laplacian(g).tocoo()
    n = lap.shape[0]
    # global FastGCN probabilities p_i ∝ ||L[:, i]||² (ref utils.py:215-222)
    p = np.zeros(n, np.float64)
    np.add.at(p, lap.col, lap.data.astype(np.float64) ** 2)
    if flatten:
        p = np.sqrt(p)
    pfull = (p / max(p.sum(), 1e-30)).astype(np.float32)

    # ELL rows sorted by |value| descending: truncation keeps the heaviest edges
    order = np.lexsort((-np.abs(lap.data), lap.row))
    row, col, val = lap.row[order], lap.col[order], lap.data[order]
    counts = np.bincount(row, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(row)) - starts[row]
    keep = pos < k
    ell_col = np.full((n, k), -1, np.int32)
    ell_val = np.zeros((n, k), np.float32)
    ell_col[row[keep], pos[keep]] = col[keep]
    ell_val[row[keep], pos[keep]] = val[keep]

    prob, alias = build_alias_table(pfull)
    return DeviceLap(
        ell_col=jnp.asarray(ell_col),
        ell_val=jnp.asarray(ell_val),
        p_packed=jnp.asarray(pack_1d(pfull)),
        alias_prob_p=jnp.asarray(pack_1d(prob)),
        alias_idx_p=jnp.asarray(pack_1d(alias.astype(np.int32))),
        n_node=int(n),
        k=int(k),
    )


def alias_draw(lap: DeviceLap, key: jax.Array, s: int) -> jax.Array:
    """``s`` i.i.d. draws from the FastGCN global distribution (2 table lookups)."""
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, (s,))
    slot = jnp.minimum((u * lap.n_node).astype(jnp.int32), lap.n_node - 1)
    accept = jax.random.uniform(k2, (s,)) < take_packed(lap.alias_prob_p, slot)
    return jnp.where(accept, slot, take_packed(lap.alias_idx_p, slot)).astype(jnp.int32)


def _layer(lap: DeviceLap, prev_ids, prev_mask, s: int, key, mode: str
           ) -> WeightedBlock:
    """One layer-wise sampling layer: draw s columns, build the weighted block.

    Memory note: the slot-matching compare materialises an
    ``[n_prev*K, n_prev+s]`` boolean matrix (LADIES adds an ``[s, n_prev*K]``
    CDF compare) — O(n_prev²·K) growth with the frontier. Fine at the
    benchmarked sizes (b=1024, s≤4096, K=32 → ~0.7 GB peak inside the scan);
    very large batch×layer-size×K products will exhaust HBM — shrink K or the
    layer sizes rather than the batch (the compare scales linearly in K).
    """
    n_prev = int(prev_ids.shape[0])
    K = lap.k
    safe = jnp.where(prev_mask, prev_ids, 0).astype(jnp.int32)
    cols = jnp.take(lap.ell_col, safe, axis=0)          # [n_prev, K]
    vals = jnp.take(lap.ell_val, safe, axis=0)          # [n_prev, K]
    valid = (cols >= 0) & prev_mask[:, None]
    vals = jnp.where(valid, vals, 0.0)
    cand = jnp.where(valid, cols, -1).reshape(-1)        # [nK] global ids (-1 pad)
    nK = cand.shape[0]

    if mode == "fastgcn":
        drawn = alias_draw(lap, key, s)                                 # [s]
    else:  # ladies: draw EDGES ∝ L² over the window grid (column marginal = p_j)
        w2 = (vals * vals).reshape(-1)                                  # [nK]
        cum = jnp.cumsum(w2)
        tot = jnp.maximum(cum[-1], 1e-30)
        u = jax.random.uniform(key, (s,)) * tot
        # first index with cum >= u  (vectorised; [s, nK] compare on the VPU)
        pick = jnp.argmax(cum[None, :] >= u[:, None], axis=1)
        drawn = jnp.maximum(cand[pick], 0).astype(jnp.int32)

    src_ids = jnp.concatenate([prev_ids.astype(jnp.int32), drawn])
    src_mask = jnp.concatenate([prev_mask, jnp.ones((s,), bool)])
    n_src = n_prev + s

    # map every window edge to a source slot: first match wins => prev preferred
    m = (cand[:, None] == src_ids[None, :]) & src_mask[None, :] \
        & (cand[:, None] >= 0)                                          # [nK, n_src]
    hit = m.any(axis=1)
    uslot = jnp.argmax(m, axis=1).astype(jnp.int32)
    is_prev = m[:, :n_prev].any(axis=1)
    mult = jnp.where(is_prev, 1.0, m[:, n_prev:].sum(axis=1, dtype=jnp.float32))

    if mode == "fastgcn":
        pcol = take_packed(lap.p_packed, jnp.maximum(cand, 0))          # [nK]
    else:
        # p_j = Σ_edges w2·[col==j] / tot — share-my-column sums via the same m
        w2 = (vals * vals).reshape(-1)
        colw = jnp.einsum("eu,e->u", m.astype(jnp.float32), w2)          # [n_src]
        pcol = jnp.take(colw, uslot) / tot

    # Defensive importance sampling: previous-layer columns are included
    # DETERMINISTICALLY, so they take their exact Laplacian weight; only
    # drawn-only columns carry the 1/(s·p_j) rescale (x draw multiplicity).
    # The reference computes a 1/(p·s) rescale for every kept column — batch
    # nodes included — but then DROPS the values when building its DGL block
    # (MQFastGCN.py:82 passes values=[], so GraphConv renormalizes); keeping
    # the naive rescale on exact-inclusion columns amplifies them by
    # 1/(s·p_j) >> 1 and blows the loss scale (the r4 `loss 18615` artifact).
    # This estimator stays unbiased: E[Σ] = Σ_{j∈prev} L_ij x_j
    # + Σ_{j∉prev} L_ij x_j (E[mult_j] = s·p_j cancels the rescale).
    scale = 1.0 / jnp.maximum(pcol * float(s), 1e-12)
    est = jnp.where(is_prev, 1.0, mult * scale)
    w = vals.reshape(-1) * est * hit.astype(jnp.float32)
    return WeightedBlock(
        dst_ids=prev_ids.astype(jnp.int32),
        src_ids=src_ids,
        slot=jnp.where(hit, uslot, 0).reshape(n_prev, K),
        weight=w.reshape(n_prev, K),
        dst_mask=prev_mask,
        src_mask=src_mask,
        n_dst=n_prev,
        n_src=n_src,
        k=K,
    )


def sample_blocks_device_layerwise(
    lap: DeviceLap,
    seeds: jax.Array,          # [b] int32 (padded entries allowed)
    seed_mask: jax.Array,      # [b] bool
    layer_sizes: Sequence[int],  # outermost (input-side) first, host convention
    key: jax.Array,
    mode: str = "fastgcn",
) -> Tuple[jax.Array, jax.Array, List[WeightedBlock]]:
    """Jit-compatible layer-wise block sampling; blocks outermost-first.

    Mirrors :class:`~dgll_tpu.sampling.layerwise.LayerWiseSampler.sample`:
    iterate from the output layer downwards, each layer's sources become the
    next layer's destinations (``src_ids = [prev | drawn]``).
    """
    assert mode in ("fastgcn", "ladies"), mode
    seeds = seeds.astype(jnp.int32)
    prev_ids, prev_mask = seeds, seed_mask
    blocks: List[WeightedBlock] = []
    for li, s in enumerate(reversed([int(x) for x in layer_sizes])):
        blk = _layer(lap, prev_ids, prev_mask, s, jax.random.fold_in(key, li),
                     mode)
        blocks.insert(0, blk)
        prev_ids, prev_mask = blk.src_ids, blk.src_mask
    input_nodes = blocks[0].src_ids if blocks else seeds
    return input_nodes, seeds, blocks


class DeviceLayerWiseSampler:
    """Object wrapper matching :class:`DeviceNeighborSampler`'s call shape."""

    def __init__(self, layer_sizes: Sequence[int], mode: str = "fastgcn"):
        self.layer_sizes = [int(s) for s in layer_sizes]
        self.mode = mode

    def sample(self, lap: DeviceLap, seeds, key, seed_mask=None):
        seeds = jnp.asarray(seeds, jnp.int32)
        if seed_mask is None:
            seed_mask = jnp.ones(seeds.shape, bool)
        return sample_blocks_device_layerwise(
            lap, seeds, seed_mask, self.layer_sizes, key, mode=self.mode)
