"""HBM-resident hot-node feature cache.

Re-design of ``GraphCacheServer``
(``/root/reference/dgll/FeatureCache/storage.py:12-221``): for graphs whose feature
matrix exceeds device HBM, keep the hottest rows (top in/out-degree — the reference's
policy, ``storage.py:94-98``) resident on device and serve misses from the host store
with one batched transfer per minibatch.

Mapping from the reference:

* ``auto_cache``          -> :meth:`auto_cache` (capacity from an HBM byte budget
  instead of CUDA mem probes, ``storage.py:64-98``)
* ``cache_fix_data``      -> :meth:`fill` (explicit node set)
* ``fetch_data``/``fetch_from_cache``/``get_feat_from_server``
                          -> :meth:`fetch` (device gather for hits + host gather/H2D
  for misses, merged on device; hit/miss split is computed host-side from a numpy
  mirror of the cache map so the device never round-trips during sampling)
* ``get_miss_rate``       -> :meth:`miss_rate` (hit/miss counters)
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class HBMFeatureCache:
    def __init__(self, host_features: np.ndarray, device: Optional[jax.Device] = None,
                 quantize: bool = False):
        """``quantize=True`` stores cached rows int8 (per-column scales), quadrupling
        capacity per HBM byte — the architecture's Quantization block applied to the
        cache (dequantisation fuses into the post-fetch compute)."""
        self.host = np.ascontiguousarray(host_features)
        self.n, self.d = self.host.shape
        self.device = device
        self.quantize = quantize
        self.cache: Optional[jax.Array] = None        # [K, d] device (or QuantizedFeatures)
        self.cache_pos = np.full(self.n, -1, np.int64)  # host mirror: node -> cache row
        self.k = 0
        self.lookups = 0
        self.misses = 0

    # ------------------------------------------------------------------ fill
    def capacity_for_budget(self, budget_bytes: int) -> int:
        """Rows that fit in ``budget_bytes`` (ref capacity model, ``storage.py:72-82``)."""
        row = self.d * (1 if self.quantize else self.host.dtype.itemsize)
        return max(0, int(budget_bytes // row))

    def auto_cache(self, scores: np.ndarray, budget_bytes: int) -> int:
        """Cache the top-scoring nodes (typically degrees) within the byte budget."""
        k = min(self.capacity_for_budget(budget_bytes), self.n)
        if k <= 0:
            return 0
        top = np.argpartition(-np.asarray(scores), k - 1)[:k]
        self.fill(top)
        return k

    def device_budget_bytes(self, reserve_bytes: int = 1 << 30) -> Optional[int]:
        """Free-HBM budget probed from the live device, the reference's capacity
        model (``storage.py:72-82``: total - peak allocated - reserve). Returns
        None when the backend exposes no memory stats (probe after the first
        training step so peak compile/working memory is already counted, like the
        reference's auto_cache-after-step-1, ``gcn.py:96-97``)."""
        d = self.device or jax.local_devices()[0]
        stats = d.memory_stats() or {}
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        if not limit:
            return None
        in_use = stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0))
        return max(0, int(limit) - int(in_use) - int(reserve_bytes))

    def auto_cache_from_device(self, scores: np.ndarray,
                               reserve_bytes: int = 1 << 30) -> int:
        """``auto_cache`` with the budget probed from the device's memory stats."""
        budget = self.device_budget_bytes(reserve_bytes)
        if budget is None:
            return 0
        return self.auto_cache(scores, budget)

    def fill(self, node_ids: np.ndarray) -> None:
        node_ids = np.asarray(node_ids, np.int64)
        self.k = len(node_ids)
        self.cache_pos[:] = -1
        self.cache_pos[node_ids] = np.arange(self.k)
        rows = self.host[node_ids]
        if self.quantize:
            from dgll_tpu.ops.quantize import quantize_int8

            self.cache = quantize_int8(rows)
        else:
            self.cache = (
                jax.device_put(rows, self.device) if self.device else jnp.asarray(rows)
            )

    @property
    def cached_whole_graph(self) -> bool:
        return self.k >= self.n

    # ----------------------------------------------------------------- fetch
    def fetch(self, node_ids: np.ndarray) -> jax.Array:
        """Features for ``node_ids`` [B] -> [B, d] on device.

        Hits gather from the HBM cache; misses are gathered host-side and shipped in
        one H2D transfer, then merged with a device scatter. Shapes vary with the miss
        count, so call outside jit (the downstream train step is the jitted part).
        """
        node_ids = np.asarray(node_ids, np.int64)
        self.lookups += len(node_ids)
        if self.cache is None:
            self.misses += len(node_ids)  # no cache: every row comes from the host
            return jnp.asarray(self.host[node_ids])

        pos = self.cache_pos[node_ids]
        hit = pos >= 0
        n_miss = int((~hit).sum())
        self.misses += n_miss

        safe_pos = np.where(hit, pos, 0)
        pos_dev = jnp.asarray(safe_pos, jnp.int32)
        if self.quantize:
            out = self.cache.gather(pos_dev)
        else:
            out = jnp.take(self.cache, pos_dev, axis=0)
        if n_miss:
            miss_idx = np.nonzero(~hit)[0]
            # Ship each missed row ONCE: sampled frontiers repeat hot nodes, so
            # deduplicating before the host gather + H2D cuts the miss payload
            # (the reference ships the raw id list, storage.py:151-198) —
            # duplicates are re-expanded
            # by a device-side gather of the small unique block.
            uniq, inv = np.unique(node_ids[miss_idx], return_inverse=True)
            miss_feats = jnp.asarray(self.host[uniq])
            out = out.at[jnp.asarray(miss_idx, jnp.int32)].set(
                jnp.take(miss_feats, jnp.asarray(inv, jnp.int32), axis=0))
        return out

    # --------------------------------------------------------------- metrics
    def miss_rate(self) -> Tuple[float, int, int]:
        """(miss_rate, lookups, misses) — ref ``get_miss_rate`` (``storage.py:217-221``)."""
        rate = self.misses / self.lookups if self.lookups else 0.0
        return rate, self.lookups, self.misses

    def reset_counters(self) -> None:
        self.lookups = 0
        self.misses = 0
