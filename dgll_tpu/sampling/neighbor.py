"""Multi-layer uniform neighbour sampler — parity with ``DGLLNeighborSampler``
(``/root/reference/dgll/sampling/dgllsampler.py:5-21``), emitting fixed-shape blocks.

Semantics: iterate fanouts outermost-first in the returned list (``fanouts[0]`` is the
block nearest the raw input features, exactly as the reference builds by inserting at
the front while iterating ``reversed(fanouts)``). Every block is fanout-dense and
statically shaped, so the jitted train step never recompiles across batches.

Hot path: the whole multi-layer batch is ONE native call
(``dgll_sample_block_fused``, csrc/graph_kernels.cpp) writing the frontier-growth
buffer in place; every Block is a zero-copy view of it. The pure-numpy per-layer
path remains as the no-toolchain fallback.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dgll_tpu import native
from dgll_tpu.sampling.base import BaseSampler, Block, HostGraph, sample_neighbors_padded


def _blocks_from_fused(ids, mask, sizes, fanouts) -> List[Block]:
    """Wrap the fused buffer into outermost-first Blocks (zero-copy views).

    ``fanouts`` is model order; the buffer grew innermost-first, so layer k of
    the growth (fanout ``reversed(fanouts)[k]``) becomes ``blocks[-1-k]``.
    """
    blocks: List[Block] = []
    for k, fanout in enumerate(reversed(list(fanouts))):
        n_k = sizes[k]
        blocks.insert(
            0,
            Block(
                dst_ids=ids[:n_k],
                src_ids=ids[: sizes[k + 1]],
                neigh_mask=mask[n_k : sizes[k + 1]].reshape(n_k, fanout).view(np.bool_),
                dst_mask=mask[:n_k].view(np.bool_),
                fanout=int(fanout),
                n_dst=int(n_k),
            ),
        )
    return blocks


class NeighborSampler(BaseSampler):
    def __init__(self, fanouts: Sequence[int], seed: int = 0):
        self.fanouts = [int(f) for f in fanouts]
        self._rng = np.random.default_rng(seed)
        # multi-producer DataLoaders call sample() concurrently; Generator
        # isn't thread-safe, so the per-batch seed draw takes this lock
        self._rng_lock = threading.Lock()

    # community ranges (CommunityNeighborSampler overrides)
    _lo: int = 0
    _hi: Optional[int] = None

    def sample(
        self,
        g: HostGraph,
        seeds: np.ndarray,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, List[Block]]:
        """Sample the multi-hop neighbourhood of ``seeds``.

        Returns ``(input_nodes, output_nodes, blocks)``: ``input_nodes`` are the global
        ids whose features feed the first block (= ``blocks[0].src_ids``),
        ``output_nodes`` the (padded) seeds. ``pad_to`` pads the seed batch to a static
        size (defaults to ``len(seeds)``).
        """
        seeds = np.asarray(seeds, np.int64)
        b = len(seeds) if pad_to is None else int(pad_to)
        pad_value = self._lo  # 0 for unrestricted; community lo keeps ids in range
        dst_ids = np.full(b, pad_value, np.int64)
        dst_ids[: len(seeds)] = seeds
        dst_mask = np.zeros(b, bool)
        dst_mask[: len(seeds)] = True

        with self._rng_lock:
            batch_seed = int(self._rng.integers(0, 2**63 - 1))
        fused = native.sample_block_fused(
            g.indptr, g.src, dst_ids, dst_mask,
            list(reversed(self.fanouts)), batch_seed,
            lo=self._lo, hi=self._hi,
        )
        if fused is not None:
            ids, mask, sizes = fused
            blocks = _blocks_from_fused(ids, mask, sizes, self.fanouts)
            input_nodes = (
                np.asarray(blocks[0].src_ids, np.int64) if blocks else dst_ids
            )
            return input_nodes, dst_ids, blocks

        # numpy fallback: per-layer sampling + concat growth (fresh per-batch
        # Generator so concurrent producers never share RNG state)
        rng = np.random.default_rng(batch_seed)
        blocks: List[Block] = []
        frontier, fmask = dst_ids, dst_mask
        for fanout in reversed(self.fanouts):
            sampled, smask = sample_neighbors_padded(g, frontier, fmask, fanout, rng)
            if self._hi is not None or self._lo:
                hi = np.iinfo(np.int64).max if self._hi is None else self._hi
                in_range = (sampled >= self._lo) & (sampled < hi)
                # out-of-range neighbours alias their destination (weight-0 via
                # the mask), so every id a batch touches stays inside [lo, hi)
                sampled = np.where(in_range, sampled, frontier[:, None])
                smask &= in_range
            # Keep leaves as host numpy: samplers are host-side producers; arrays move
            # to device in one batch at jit-call time (no per-array transfers and
            # no device round-trip during sampling).
            blocks.insert(
                0,
                Block(
                    dst_ids=frontier.astype(np.int32),
                    src_ids=np.concatenate([frontier, sampled.reshape(-1)]).astype(np.int32),
                    neigh_mask=smask,
                    dst_mask=fmask,
                    fanout=fanout,
                    n_dst=frontier.shape[0],
                ),
            )
            frontier = np.concatenate([frontier, sampled.reshape(-1)])
            fmask = np.concatenate([fmask, smask.reshape(-1)])

        input_nodes = np.asarray(blocks[0].src_ids, np.int64) if blocks else dst_ids
        return input_nodes, dst_ids, blocks

    def sample_packed(
        self, g: HostGraph, seeds: np.ndarray, pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The transfer-minimal form of :meth:`sample`: returns just
        ``(ids int32 [n_final], mask uint8 [n_final])`` — the frontier-growth
        buffers every Block is a view of. Ship these two arrays to the device
        and rebuild the blocks INSIDE the jitted step
        (``trainer.make_packed_block_step``): 2 H2D transfers per batch instead
        of 8.
        """
        seeds = np.asarray(seeds, np.int64)
        b = len(seeds) if pad_to is None else int(pad_to)
        dst_ids = np.full(b, self._lo, np.int64)
        dst_ids[: len(seeds)] = seeds
        dst_mask = np.zeros(b, bool)
        dst_mask[: len(seeds)] = True
        with self._rng_lock:
            batch_seed = int(self._rng.integers(0, 2**63 - 1))
        fused = native.sample_block_fused(
            g.indptr, g.src, dst_ids, dst_mask,
            list(reversed(self.fanouts)), batch_seed,
            lo=self._lo, hi=self._hi,
        )
        if fused is not None:
            ids, mask, _ = fused
            return ids, mask
        # no native lib: build the buffers from the per-layer fallback blocks
        _, _, blocks = self.sample(g, seeds, pad_to)
        n_final = blocks[0].n_src if blocks else b
        ids = np.empty(n_final, np.int32)
        mask = np.empty(n_final, np.uint8)
        ids[:b] = dst_ids
        mask[:b] = dst_mask
        for blk in reversed(blocks):
            n_k = blk.n_dst
            ids[n_k : n_k * (1 + blk.fanout)] = np.asarray(blk.src_ids)[n_k:]
            mask[n_k : n_k * (1 + blk.fanout)] = np.asarray(blk.neigh_mask).reshape(-1)
        return ids, mask

    @staticmethod
    def packed_sizes(batch: int, fanouts: Sequence[int]) -> List[int]:
        """Frontier lengths after each growth layer: ``sizes[0] == batch``."""
        sizes = [int(batch)]
        for f in reversed([int(x) for x in fanouts]):
            sizes.append(sizes[-1] * (1 + f))
        return sizes


# Alias matching the reference class name for drop-in familiarity.
DGLLNeighborSampler = NeighborSampler


class CommunityNeighborSampler(NeighborSampler):
    """Neighbour sampler restricted to a community's contiguous id range.

    Parity with the community trainers' ``CommBNeighborSampler``
    (``CommGNN_train.py:100-108`` — implementation absent from the reference
    snapshot; designed from call sites): seeds and sampled neighbours stay inside
    ``[lo, hi)``, so every feature row a batch touches lives in one contiguous
    slice (the property COG's relabeling creates). Out-of-range neighbours are
    masked out, matching the transductive "MOS" slicing (``CommGNNModel.py:54-56``).
    """

    def __init__(self, fanouts: Sequence[int], community_range: Tuple[int, int],
                 seed: int = 0):
        super().__init__(fanouts, seed)
        self.lo, self.hi = int(community_range[0]), int(community_range[1])
        self._lo, self._hi = self.lo, self.hi

    def sample(self, g: HostGraph, seeds: np.ndarray, pad_to: Optional[int] = None):
        seeds = np.asarray(seeds, np.int64)
        assert ((seeds >= self.lo) & (seeds < self.hi)).all(), "seeds outside community"
        return super().sample(g, seeds, pad_to)
