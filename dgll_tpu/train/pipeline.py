"""MQ-style pipelined trainer: cache-aware feature fetch + prefetch-overlapped steps.

The flagship runtime — capability twin of MQ-GNN
(``/root/reference/dgll/GPU Accelerator/buffer_queues.py`` + ``MQGCN.py``) and the
cached trainers (``FeatureCache/gcn.py:24-110``), as one coherent design:

* the DataLoader's producer thread samples ahead (MQ-GNN's CPU/GPU queues);
* features come through :class:`~dgll_tpu.cache.HBMFeatureCache` when the matrix
  doesn't fit HBM (GraphCacheServer role), or a plain device gather when it does;
* the jitted step runs under JAX async dispatch, so device compute overlaps both the
  host sampling and the next batch's transfer (MQ-GNN's CUDA-stream overlap);
* per-phase wall-clock + cache miss-rate land in a :class:`PhaseTimer` — the
  observability the reference got from ``torch.autograd.profiler`` scopes
  ('gpu-load'/'gpu-compute', ``FeatureCache/gcn.py:78-109``).
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dgll_tpu.cache import HBMFeatureCache
from dgll_tpu.dataloader import DataLoader
from dgll_tpu.sampling import HostGraph
from dgll_tpu.train.metrics import masked_nll_loss
from dgll_tpu.train.trainer import TrainState, create_train_state, make_block_eval, make_block_step
from dgll_tpu.utils.profiling import PhaseTimer


class PipelinedTrainer:
    def __init__(
        self,
        model,
        optimizer: optax.GradientTransformation,
        g,
        sampler,
        batch_size: int,
        features,                       # device array OR HBMFeatureCache
        labels,
        loss_fn=masked_nll_loss,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.model = model
        self.g = g
        self.sampler = sampler
        self.batch_size = batch_size
        self.host_g = HostGraph.from_graph(g)
        self.cache = features if isinstance(features, HBMFeatureCache) else None
        self.features = None if self.cache else jnp.asarray(features)
        self.labels = jnp.asarray(np.asarray(labels))
        self.step = make_block_step(loss_fn)
        self.evaluate = make_block_eval()
        self.optimizer = optimizer
        self.prefetch = prefetch
        self.seed = seed
        self.rng = jax.random.key(seed)
        self.timer = PhaseTimer()
        self.state: Optional[TrainState] = None

    # ---------------------------------------------------------------- helpers
    def _fetch(self, ids) -> jax.Array:
        if self.cache is not None:
            return self.cache.fetch(np.asarray(ids))
        return jnp.take(self.features, jnp.asarray(ids), axis=0)

    def _loader(self, seeds, shuffle=True, seed=0) -> DataLoader:
        return DataLoader(self.host_g, seeds, self.sampler, self.batch_size,
                          shuffle=shuffle, prefetch=self.prefetch, seed=seed)

    def init(self, seeds) -> "PipelinedTrainer":
        _, _, b0 = self.sampler.sample(self.host_g, np.asarray(seeds)[: self.batch_size],
                                       pad_to=self.batch_size)
        x0 = self._fetch(b0[0].src_ids)
        self.rng, k = jax.random.split(self.rng)
        self.state = create_train_state(self.model, k, self.optimizer, list(b0), x0)
        return self

    # ------------------------------------------------------------------ train
    def train_epoch(self, train_seeds, epoch: int = 0) -> float:
        assert self.state is not None, "call init() first"
        loader = self._loader(train_seeds, seed=self.seed + epoch)
        total, nb = 0.0, 0
        loss = None
        for inp, out, blocks in loader:                       # producer overlaps
            with self.timer.phase("load"):
                x = self._fetch(blocks[0].src_ids)
                y = jnp.take(self.labels, jnp.asarray(blocks[-1].dst_ids), axis=0)
            with self.timer.phase("compute"):
                self.rng, k = jax.random.split(self.rng)
                self.state, loss = self.step(self.state, tuple(blocks), x, y,
                                             blocks[-1].dst_mask, k)
            nb += 1
        if loss is not None:
            total = float(loss)                                # one sync per epoch
        return total

    def evaluate_nodes(self, seeds) -> float:
        loader = self._loader(seeds, shuffle=False, seed=1)
        hits, count = 0.0, 0.0
        for inp, out, blocks in loader:
            x = self._fetch(blocks[0].src_ids)
            logp = self.evaluate(self.state, tuple(blocks), x)
            y = np.asarray(jnp.take(self.labels, jnp.asarray(blocks[-1].dst_ids), axis=0))
            m = np.asarray(blocks[-1].dst_mask)
            hits += float(((np.asarray(logp).argmax(-1) == y) * m).sum())
            count += float(m.sum())
        return hits / max(count, 1.0)

    def fit(self, train_seeds, val_seeds=None, epochs: int = 10, patience: int = 0,
            log=None) -> dict:
        best_val, bad = -np.inf, 0
        history = []
        t0 = time.perf_counter()
        for epoch in range(epochs):
            te = time.perf_counter()
            loss = self.train_epoch(train_seeds, epoch)
            dt = time.perf_counter() - te
            val = None
            if val_seeds is not None and len(val_seeds):
                val = self.evaluate_nodes(val_seeds)
                if val > best_val:
                    best_val, bad = val, 0
                else:
                    bad += 1
            history.append({"epoch": epoch, "loss": loss, "s": dt, "val": val})
            if log:
                log.info(f"epoch {epoch} loss {loss:.4f} val {val} ({dt:.2f}s)")
            if patience and bad >= patience:
                break
        out = {
            "history": history,
            "best_val": best_val,
            "total_s": time.perf_counter() - t0,
            "phases": self.timer.summary(),
        }
        if self.cache is not None:
            rate, lookups, misses = self.cache.miss_rate()
            out["cache_miss_rate"] = rate
        return out


# Compat alias: the reference's flagship runtime name.
MQTrainer = PipelinedTrainer
