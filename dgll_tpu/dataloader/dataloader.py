"""Minibatch dataloader with host-side sampling overlapped against device compute.

Replaces two reference components with one design:

* the native ``DataLoader`` (``/root/reference/dgll/dataloader/dataloader.py:4-24`` —
  note its ``__iter__`` iterates an attribute that is never set; we keep the intended
  semantics from ``graphage.py:37-51``), and
* the MQ-GNN producer/consumer CUDA-stream pipeline
  (``GPU Accelerator/buffer_queues.py:22-119``): JAX dispatch is already
  asynchronous, so a producer thread that samples the *next* batches and ``device_put``s
  them while the jitted step runs gives the same sample/compute overlap without CUDA
  streams — the queue depth here plays the role of MQ-GNN's bounded ``gpu_queue``.

Yields ``(input_nodes, output_nodes, blocks)`` per batch, matching the reference API.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import jax
import numpy as np

from dgll_tpu.graph import Graph
from dgll_tpu.sampling.base import BaseSampler, HostGraph


class DataLoader:
    def __init__(
        self,
        g,
        seeds: Sequence[int],
        sampler: BaseSampler,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        prefetch: int = 2,
        device: Optional[jax.Device] = None,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        n_producers: int = 1,
        packed: bool = False,
    ):
        """``num_shards``/``shard_index`` give per-rank seed sharding (the reference's
        ``use_ddp=True`` dataloader split, ``MQGCN.py:121``). ``n_producers`` > 1
        samples batches on several host threads concurrently (the C++ sampler
        releases the GIL); batch order is then nondeterministic within an epoch.
        ``packed=True`` yields ``(ids, mask)`` frontier-growth buffers instead of
        ``(inp, out, blocks)`` — 2 H2D transfers per batch; consume with
        ``make_packed_block_step`` (requires a sampler with ``sample_packed``)."""
        self.host_g = g if isinstance(g, HostGraph) else HostGraph.from_graph(g)
        self.seeds = np.asarray(seeds, np.int64)
        if num_shards > 1:
            self.seeds = self.seeds[shard_index::num_shards]
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(int(prefetch), 0)
        self.device = device
        self.n_producers = max(int(n_producers), 1)
        self.packed = bool(packed)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.seeds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = self._rng.permutation(len(self.seeds)) if self.shuffle else np.arange(len(self.seeds))
        seeds = self.seeds[order]
        nb = len(self)
        for i in range(nb):
            yield seeds[i * self.batch_size : (i + 1) * self.batch_size]

    def _make(self, batch_seeds):
        if self.packed:
            ids, mask = self.sampler.sample_packed(
                self.host_g, batch_seeds, pad_to=self.batch_size)
            if self.device is not None:
                ids, mask = jax.device_put((ids, mask), self.device)
            return ids, mask
        inp, out, blocks = self.sampler.sample(self.host_g, batch_seeds, pad_to=self.batch_size)
        if self.device is not None:
            blocks = jax.device_put(blocks, self.device)
        return inp, out, blocks

    def __iter__(self) -> Iterator:
        if self.prefetch == 0 and self.n_producers <= 1:
            for bs in self._batches():
                yield self._make(bs)
            return

        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        _SENTINEL = object()
        err: list = []
        n_prod = self.n_producers
        work = iter(list(self._batches()))
        work_lock = threading.Lock()

        def producer():
            try:
                while True:
                    with work_lock:
                        bs = next(work, None)
                    if bs is None:
                        return
                    q.put(self._make(bs))
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        threads = [threading.Thread(target=producer, daemon=True) for _ in range(n_prod)]
        for t in threads:
            t.start()
        done = 0
        while done < n_prod:
            item = q.get()
            if item is _SENTINEL:
                done += 1
                continue
            yield item
        for t in threads:
            t.join()
        if err:
            raise err[0]
