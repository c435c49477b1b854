"""On-device neighbour sampling: the CSR lives in device memory and fanout
sampling is a jitted gather — zero host work, zero host->device transfer per
batch.

Redesign of the reference's minibatch producer. The reference samples on the
CPU per batch (``/root/reference/dgll/sampling/base_sampler.py:45-58``,
pipelined behind CUDA streams by ``GPU Accelerator/buffer_queues.py:22-70``);
here the CSR stays device-resident (ogbn-products scale: 60 M edges * int32 =
240 MB) and the fanout sample is drawn inside the train step itself. An entire
epoch then compiles to ONE XLA program (``lax.scan`` over batches in
``train/device_pipeline.py``) with no dispatch gaps.

Layout note: the CSR tables are stored packed as ``[ceil(n/128), 128]`` and
every scalar lookup is a row gather + one-hot lane select (:func:`take_packed`).
The layout was chosen because a scalar gather from a 1-D array was slow on the
accelerator this was first built for; whether it still pays on the GPU against
a direct ``jnp.take`` is not measured yet.

Semantics match :class:`~dgll_tpu.sampling.neighbor.NeighborSampler` exactly:
with-replacement uniform fanout over in-edges, masked fallback-to-self for
zero-degree/padded rows, blocks emitted outermost-first with the
``src_ids = [dst_ids | sampled]`` layout of :class:`Block`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dgll_tpu.sampling.base import Block
from dgll_tpu.utils import struct

LANE = 128  # packing granularity (row width) of the 1-D tables


def pack_1d(a: np.ndarray) -> np.ndarray:
    """Pack a flat array into the [ceil(n/LANE), LANE] layout ``take_packed`` reads."""
    a = np.asarray(a)
    rows = max(1, -(-len(a) // LANE))
    out = np.zeros((rows, LANE), a.dtype)
    out.reshape(-1)[: len(a)] = a
    return out


def take_packed(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Vectorised 1-D gather: ``flat[idx]`` where ``table`` is ``pack_1d(flat)``.

    Row-gather + one-hot lane select (see module docstring). ``idx`` may have
    any shape.
    """
    flat = idx.reshape(-1)
    rows = jnp.take(table, flat // LANE, axis=0)          # [k, LANE]
    lane = (flat % LANE)[:, None]
    iota = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    out = jnp.where(iota == lane, rows, 0).sum(axis=1, dtype=table.dtype)
    return out.reshape(idx.shape)


@struct.dataclass
class DeviceCSR:
    """Device-resident in-edge CSR (the sampling view of a :class:`Graph`).

    ``indptr[v]:indptr[v+1]`` spans the in-edges of ``v``; ``src[k]`` is the
    neighbour a message arrives from. Tables are stored packed (see module
    docstring); int32 throughout — graphs past 2^31 edges would need the
    (x64-enabled) int64 variant.
    """

    indptr_p: jax.Array  # pack_1d(indptr) [*, LANE] int32
    src_p: jax.Array     # pack_1d(src)    [*, LANE] int32
    n_node: int = struct.field(pytree_node=False, default=0)
    n_edge: int = struct.field(pytree_node=False, default=0)

    @staticmethod
    def from_graph(g) -> "DeviceCSR":
        """Build from a Graph (real nodes/edges only; cf. HostGraph.from_graph)."""
        indptr = np.asarray(g.indptr)[: g.n_real_node + 1].copy()
        indptr[-1] = min(int(indptr[-1]), g.n_real_edge)
        return DeviceCSR.from_host_arrays(indptr, np.asarray(g.src)[: g.n_real_edge])

    @staticmethod
    def from_host_arrays(indptr, src) -> "DeviceCSR":
        indptr = np.asarray(indptr)
        src = np.asarray(src)
        if len(src) > np.iinfo(np.int32).max:
            raise ValueError("DeviceCSR is int32; graph exceeds 2^31 edges")
        return DeviceCSR(
            indptr_p=jnp.asarray(pack_1d(indptr.astype(np.int32))),
            src_p=jnp.asarray(pack_1d(src.astype(np.int32))),
            n_node=int(len(indptr) - 1),
            n_edge=int(len(src)),
        )


def sample_layer_device(
    csr: DeviceCSR,
    frontier: jax.Array,       # [n] int32 global ids
    fmask: jax.Array,          # [n] bool
    fanout: int,
    key: jax.Array,
    window: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """[n, fanout] with-replacement uniform in-neighbour sample + validity mask.

    Mirrors ``dgll_sample_neighbors`` (csrc/graph_kernels.cpp) on device: invalid
    (masked / zero-degree) rows emit the row's own id with mask 0.

    ``window=True`` switches to block-window sampling: ONE packed CSR row
    (LANE consecutive edge slots) is fetched per frontier node — the anchor slot
    is drawn uniformly over the node's edge range, so the window is chosen with
    probability proportional to its overlap with the range — and all ``fanout``
    draws come uniformly from the valid lanes of that window. Each draw's
    marginal distribution is exactly uniform over the node's neighbours
    (P(window)·P(lane|window) = overlap/deg · 1/overlap = 1/deg); draws within
    one node are correlated (same window) but aggregation stays unbiased. It
    fetches one window row per node instead of one row per (node, slot), which
    cuts the rows gathered by the fanout factor.
    """
    n = frontier.shape[0]
    safe = jnp.where(fmask, frontier, 0).astype(jnp.int32)
    bounds = take_packed(csr.indptr_p, jnp.stack([safe, safe + 1]))
    start, deg = bounds[0], bounds[1] - bounds[0]
    ok = fmask & (deg > 0)
    if not window:
        u = jax.random.uniform(key, (n, fanout))
        off = (u * jnp.maximum(deg, 1)[:, None].astype(u.dtype)).astype(jnp.int32)
        idx = jnp.minimum(start[:, None] + off, max(csr.n_edge - 1, 0))
        sampled = take_packed(csr.src_p, idx)
    else:
        ka, kl = jax.random.split(key)
        ua = jax.random.uniform(ka, (n,))
        anchor = start + (ua * jnp.maximum(deg, 1).astype(ua.dtype)).astype(jnp.int32)
        anchor = jnp.minimum(anchor, max(csr.n_edge - 1, 0))
        row = anchor // LANE
        rows = jnp.take(csr.src_p, row, axis=0)               # [n, LANE]
        lo = jnp.maximum(start - row * LANE, 0)               # first valid lane
        hi = jnp.minimum(start + deg - row * LANE, LANE)      # one past last
        span = jnp.maximum(hi - lo, 1)
        ul = jax.random.uniform(kl, (n, fanout))
        lane = lo[:, None] + (ul * span[:, None].astype(ul.dtype)).astype(jnp.int32)
        iota = jax.lax.broadcasted_iota(jnp.int32, (n, 1, LANE), 2)
        sel = iota == lane[:, :, None]                        # [n, fanout, LANE]
        sampled = jnp.where(sel, rows[:, None, :], 0).sum(axis=2, dtype=jnp.int32)
    mask = jnp.broadcast_to(ok[:, None], (n, fanout))
    sampled = jnp.where(mask, sampled, frontier[:, None])
    return sampled.astype(jnp.int32), mask


def sample_blocks_device(
    csr: DeviceCSR,
    seeds: jax.Array,          # [b] int32 global ids (padded entries allowed)
    seed_mask: jax.Array,      # [b] bool
    fanouts: Sequence[int],
    key: jax.Array,
    window: bool = False,
) -> Tuple[jax.Array, jax.Array, List[Block]]:
    """Jit-compatible multi-layer block sampling (NeighborSampler.sample parity).

    Returns ``(input_nodes, output_nodes, blocks)`` with blocks outermost-first;
    all shapes are static functions of ``(len(seeds), fanouts)``.
    ``window`` selects block-window sampling (see :func:`sample_layer_device`).
    """
    seeds = seeds.astype(jnp.int32)
    frontier, fmask = seeds, seed_mask
    blocks: List[Block] = []
    for li, fanout in enumerate(reversed(list(fanouts))):
        sampled, smask = sample_layer_device(
            csr, frontier, fmask, int(fanout), jax.random.fold_in(key, li),
            window=window,
        )
        blocks.insert(
            0,
            Block(
                dst_ids=frontier,
                src_ids=jnp.concatenate([frontier, sampled.reshape(-1)]),
                neigh_mask=smask,
                dst_mask=fmask,
                fanout=int(fanout),
                n_dst=int(frontier.shape[0]),
            ),
        )
        frontier = jnp.concatenate([frontier, sampled.reshape(-1)])
        fmask = jnp.concatenate([fmask, smask.reshape(-1)])
    input_nodes = blocks[0].src_ids if blocks else seeds
    return input_nodes, seeds, blocks


class DeviceNeighborSampler:
    """Object-style wrapper matching the ``BaseSampler`` call shape, but running
    on device. ``sample`` may be called inside ``jit`` (pass a key) or eagerly.
    """

    def __init__(self, fanouts: Sequence[int], window: bool = False):
        self.fanouts = [int(f) for f in fanouts]
        self.window = bool(window)

    def sample(self, csr: DeviceCSR, seeds, key, seed_mask=None):
        seeds = jnp.asarray(seeds, jnp.int32)
        if seed_mask is None:
            seed_mask = jnp.ones(seeds.shape, bool)
        return sample_blocks_device(csr, seeds, seed_mask, self.fanouts, key,
                                    window=self.window)
