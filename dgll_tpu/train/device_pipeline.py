"""Fully device-resident minibatch training: sampling + feature gather + step,
one XLA program per epoch.

This is the device-resident end-state of the reference's MQ-GNN pipeline
(``/root/reference/dgll/GPU Accelerator/buffer_queues.py:22-119`` +
``MQGCN.py:94-163``). The reference hides CPU-sampling latency behind CUDA
streams and bounded queues; here there is nothing to hide — the graph CSR,
features, and labels live in device memory, each batch's fanout sample is a few
gathers (``sampling/device_sampler.py``), and ``lax.scan`` strings the whole
epoch into a single dispatch, with no per-batch host round-trip.

Memory budget: products-scale (2.4 M nodes, 100-d float32 feats, 60 M edges) is
~1.2 GB of tables; training it on one H100 (80 GB) peaked at 1.4-2.9 GB in
use across runs (NVIDIA H100 80GB HBM3, 400 W limit; chip_smoke.py phase 1). For graphs
that exceed device memory, the host-side ``DataLoader`` (+ C++ fused block
sampler) path remains the fallback.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dgll_tpu.sampling.device_sampler import DeviceCSR, sample_blocks_device
from dgll_tpu.train.metrics import masked_nll_loss
from dgll_tpu.train.trainer import TrainState, create_train_state


def make_sample_fn(fanouts: Sequence[int], window: bool = False,
                   sampler: str = "neighbor"):
    """Device-sampling callable ``(graph, seeds, mask, key) -> (inp, out, blocks)``.

    ``sampler``: ``neighbor`` (uniform fanout over the HBM CSR; ``graph`` is a
    :class:`DeviceCSR`) or ``fastgcn`` / ``ladies`` (layer-wise importance
    draws; ``graph`` is a :class:`~dgll_tpu.sampling.device_layerwise.DeviceLap`
    and ``fanouts`` is read as the per-layer sample sizes, outermost first).
    """
    fanouts = [int(f) for f in fanouts]
    if sampler == "neighbor":
        def fn(graph, bs, bm, key):
            return sample_blocks_device(graph, bs, bm, fanouts, key,
                                        window=window)
    elif sampler in ("fastgcn", "ladies"):
        from dgll_tpu.sampling.device_layerwise import (
            sample_blocks_device_layerwise,
        )

        def fn(graph, bs, bm, key):
            return sample_blocks_device_layerwise(graph, bs, bm, fanouts, key,
                                                  mode=sampler)
    else:
        raise ValueError(f"unknown device sampler {sampler!r}")
    return fn


def make_device_epoch_fn(
    fanouts: Sequence[int],
    batch_size: int,
    n_batches: int,
    loss_fn: Callable = masked_nll_loss,
    feat_dtype=None,
    window: bool = False,
    sampler: str = "neighbor",
):
    """Build ``epoch(state, csr, feats, labels, seeds, seed_mask, key)``.

    ``seeds``/``seed_mask`` are [n_batches * batch_size] padded device arrays;
    the function shuffles them (one permutation per epoch), scans the batches,
    and returns ``(state, mean_loss)``. Everything, including the sampling
    (uniform neighbour or layer-wise FastGCN/LADIES — see :func:`make_sample_fn`),
    runs inside one jitted program — the epoch is a single dispatch from the host.
    """
    sample_fn = make_sample_fn(fanouts, window, sampler)
    total = int(n_batches) * int(batch_size)

    # The train state is not donated; whether donating it pays on the GPU is
    # not measured yet.
    @jax.jit
    def epoch(state: TrainState, csr: DeviceCSR, feats, labels, seeds, seed_mask, key):
        kperm, kscan = jax.random.split(key)
        order = jax.random.permutation(kperm, total)
        seeds_s = jnp.take(seeds, order)
        mask_s = jnp.take(seed_mask, order)

        def body(carry, i):
            st, k = carry
            k, ks, kd = jax.random.split(k, 3)
            off = i * batch_size
            bs = jax.lax.dynamic_slice(seeds_s, (off,), (batch_size,))
            bm = jax.lax.dynamic_slice(mask_s, (off,), (batch_size,))
            _, out, blocks = sample_fn(csr, bs, bm, ks)
            x = jnp.take(feats, blocks[0].src_ids, axis=0)
            if feat_dtype is not None:
                x = x.astype(feat_dtype)
            y = jnp.take(labels, blocks[-1].dst_ids, axis=0)

            def loss_of(params):
                logp = st.apply_fn(
                    {"params": params}, list(blocks), x, deterministic=False,
                    rngs={"dropout": kd},
                )
                return loss_fn(logp, y, blocks[-1].dst_mask)

            loss, grads = jax.value_and_grad(loss_of)(st.params)
            return (st.apply_gradients(grads=grads), k), loss

        (state2, _), losses = jax.lax.scan(
            body, (state, kscan), jnp.arange(n_batches)
        )
        return state2, losses.mean()

    return epoch


def make_device_dp_epoch_fn(
    mesh,
    fanouts: Sequence[int],
    per_device_batch: int,
    n_batches: int,
    loss_fn: Callable = masked_nll_loss,
    feat_dtype=None,
    window: bool = False,
    axis: str = "data",
    sampler: str = "neighbor",
):
    """Data-parallel twin of :func:`make_device_epoch_fn`: each mesh device
    samples ITS sub-batch from the (replicated) HBM CSR inside the program and
    gradients are ``psum``-ed — on-device sampling composed with DP, so the
    host feeds nothing per batch even at multi-chip scale (the end state the
    reference's MQ-GNN pipeline + DDP approximates with queues + NCCL,
    ``MQGCN.py:94-163``).

    ``epoch(state, csr, feats, labels, seeds, seed_mask, key)`` with
    ``seeds``/``seed_mask`` of length ``n_batches * D * per_device_batch``.
    """
    from jax.sharding import PartitionSpec as P

    from jax import shard_map

    sample_fn = make_sample_fn(fanouts, window, sampler)
    D = int(mesh.shape[axis])
    b = int(per_device_batch)
    total = int(n_batches) * D * b

    @jax.jit
    def epoch(state: TrainState, csr: DeviceCSR, feats, labels, seeds, seed_mask, key):
        kperm, kscan = jax.random.split(key)
        order = jax.random.permutation(kperm, total)
        seeds_s = jnp.take(seeds, order)
        mask_s = jnp.take(seed_mask, order)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(), P()),
            out_specs=(P(), P()),
        )
        def dp_step(params, csr_, feats_, labels_, bs, bm, kd, ks):
            bs, bm = bs.reshape(-1), bm.reshape(-1)
            # per-device keys for BOTH sampling and dropout — a replicated
            # dropout key would correlate masks across the whole mesh
            ks = jax.random.fold_in(ks, jax.lax.axis_index(axis))
            kd = jax.random.fold_in(kd, jax.lax.axis_index(axis))
            _, _, blocks = sample_fn(csr_, bs, bm, ks)
            x = jnp.take(feats_, blocks[0].src_ids, axis=0)
            if feat_dtype is not None:
                x = x.astype(feat_dtype)
            y = jnp.take(labels_, blocks[-1].dst_ids, axis=0)

            def loss_of(p):
                logp = state.apply_fn(
                    {"params": p}, list(blocks), x, deterministic=False,
                    rngs={"dropout": kd},
                )
                return loss_fn(logp, y, blocks[-1].dst_mask)

            loss, grads = jax.value_and_grad(loss_of)(params)
            grads = jax.lax.pmean(grads, axis)
            loss = jax.lax.pmean(loss, axis)
            return grads, loss

        def body(carry, i):
            st, k = carry
            k, ks, kd = jax.random.split(k, 3)
            off = i * (D * b)
            bs = jax.lax.dynamic_slice(seeds_s, (off,), (D * b,)).reshape(D, b)
            bm = jax.lax.dynamic_slice(mask_s, (off,), (D * b,)).reshape(D, b)
            grads, loss = dp_step(st.params, csr, feats, labels, bs, bm, kd, ks)
            return (st.apply_gradients(grads=grads), k), loss

        (state2, _), losses = jax.lax.scan(
            body, (state, kscan), jnp.arange(n_batches)
        )
        return state2, losses.mean()

    return epoch


def make_device_eval_fn(
    apply_fn: Callable,
    fanouts: Sequence[int],
    batch_size: int,
    n_batches: int,
    feat_dtype=None,
    window: bool = False,
    sampler: str = "neighbor",
):
    """Compiled evaluation sweep: one scanned dispatch for a whole val/test set.

    The reference folds validation into its pipeline but still walks the host
    sampler every epoch (``buffer_queues.py:47-61``); at products scale a
    host-sampled validation sweep can cost more than the device-resident train
    epoch it follows. This is the missing half: ``evaluate(params, graph,
    feats, seeds, seed_mask, key) -> (pred, valid)`` samples each batch ON
    DEVICE (same sampler family as training, deterministic given ``key``),
    applies the model with ``deterministic=True``, and returns per-seed argmax
    predictions + validity — ONE dispatch and one [total]-sized D2H per sweep.
    """
    sample_fn = make_sample_fn(fanouts, window, sampler)
    batch_size = int(batch_size)

    @jax.jit
    def evaluate(params, graph, feats, seeds, seed_mask, key):
        def body(carry, i):
            bs = jax.lax.dynamic_slice(seeds, (i * batch_size,), (batch_size,))
            bm = jax.lax.dynamic_slice(seed_mask, (i * batch_size,), (batch_size,))
            _, _, blocks = sample_fn(graph, bs, bm, jax.random.fold_in(key, i))
            x = jnp.take(feats, blocks[0].src_ids, axis=0)
            if feat_dtype is not None:
                x = x.astype(feat_dtype)
            logp = apply_fn({"params": params}, list(blocks), x,
                            deterministic=True)
            return carry, (jnp.argmax(logp, axis=-1).astype(jnp.int32),
                           blocks[-1].dst_mask)

        _, (pred, valid) = jax.lax.scan(body, 0, jnp.arange(n_batches))
        return pred.reshape(-1), valid.reshape(-1)

    return evaluate


class DeviceEpochRunner:
    """Convenience driver around :func:`make_device_epoch_fn`.

    Usage::

        runner = DeviceEpochRunner(model, optax.adam(1e-3), csr, fanouts=[15, 10],
                                   batch_size=1024, train_nodes=train_nodes)
        state = runner.init_state(feats)
        state, loss = runner.run_epoch(state, feats, labels)

    ``feats``/``labels`` must be device arrays covering all ``csr.n_node`` rows.
    """

    def __init__(
        self,
        model,
        optimizer,
        csr: DeviceCSR,
        fanouts: Sequence[int],
        batch_size: int,
        train_nodes,
        loss_fn: Callable = masked_nll_loss,
        seed: int = 0,
        feat_dtype=None,
        window: bool = False,
        sampler: str = "neighbor",
    ):
        self.model = model
        self.optimizer = optimizer
        self.csr = csr
        self.fanouts = [int(f) for f in fanouts]
        self.batch_size = int(batch_size)
        train_nodes = np.asarray(train_nodes, np.int64)
        self.n_batches = max(1, -(-len(train_nodes) // self.batch_size))
        total = self.n_batches * self.batch_size
        seeds = np.zeros(total, np.int32)
        seeds[: len(train_nodes)] = train_nodes
        mask = np.zeros(total, bool)
        mask[: len(train_nodes)] = True
        self.seeds = jnp.asarray(seeds)
        self.seed_mask = jnp.asarray(mask)
        self.rng = jax.random.key(seed)
        self.epoch_fn = make_device_epoch_fn(
            self.fanouts, self.batch_size, self.n_batches, loss_fn, feat_dtype,
            window=window, sampler=sampler,
        )
        self._feat_dtype = feat_dtype
        self._window = bool(window)
        self._sampler = sampler
        self._sample_fn = make_sample_fn(self.fanouts, window, sampler)

    def init_state(self, feats) -> TrainState:
        self.rng, kinit, ks = jax.random.split(self.rng, 3)
        b = self.batch_size

        # ONE jitted program for the sampling+gather and ONE for model.init:
        # run eagerly, every op would compile and dispatch on its own
        @jax.jit
        def sample_init(csr, feats_, key):
            seeds = jnp.arange(b, dtype=jnp.int32) % max(self.csr.n_node, 1)
            _, _, blocks = self._sample_fn(csr, seeds, jnp.ones(b, bool), key)
            x = jnp.take(feats_, blocks[0].src_ids, axis=0)
            if self._feat_dtype is not None:
                x = x.astype(self._feat_dtype)
            return blocks, x

        blocks, x = sample_init(self.csr, jnp.asarray(feats), ks)
        params = jax.jit(self.model.init)(kinit, list(blocks), x)["params"]
        return TrainState.create(apply_fn=self.model.apply, params=params,
                                 tx=self.optimizer)

    def run_epoch(self, state: TrainState, feats, labels):
        self.rng, k = jax.random.split(self.rng)
        state, loss = self.epoch_fn(
            state, self.csr, feats, labels, self.seeds, self.seed_mask, k
        )
        return state, loss

    # -- compiled evaluation (one dispatch per sweep) -----------------------
    def _eval_fn(self, n_batches: int):
        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = self._eval_cache = {}
        if n_batches not in cache:
            cache[n_batches] = make_device_eval_fn(
                self.model.apply, self.fanouts, self.batch_size, n_batches,
                feat_dtype=self._feat_dtype, window=self._window,
                sampler=self._sampler)
        return cache[n_batches]

    def predict_nodes(self, state: TrainState, feats, nodes, seed: int = 0):
        """Argmax predictions for ``nodes`` via the compiled scanned sweep.

        Deterministic given ``seed``. Returns a [len(nodes)] int32 numpy array.
        """
        nodes = np.asarray(nodes, np.int64)
        nb = max(1, -(-len(nodes) // self.batch_size))
        total = nb * self.batch_size
        seeds = np.zeros(total, np.int32)
        seeds[: len(nodes)] = nodes
        mask = np.zeros(total, bool)
        mask[: len(nodes)] = True
        pred, _ = self._eval_fn(nb)(
            state.params, self.csr, feats, jnp.asarray(seeds),
            jnp.asarray(mask), jax.random.key(seed))
        return np.asarray(pred)[: len(nodes)]

    def evaluate_nodes(self, state: TrainState, feats, labels_np, nodes,
                       seed: int = 0) -> float:
        """Accuracy over ``nodes`` (compiled sweep + host compare)."""
        nodes = np.asarray(nodes, np.int64)
        if len(nodes) == 0:
            return 0.0
        pred = self.predict_nodes(state, feats, nodes, seed)
        return float((pred == np.asarray(labels_np)[nodes]).mean())

    # -- exact (full-neighborhood) inference --------------------------------
    def predict_nodes_exact(self, state: TrainState, graph, feats, nodes):
        """Sampling-noise-free predictions: one compiled FULL-GRAPH forward
        with the minibatch-trained params (``train/exact_infer.py``; the eval
        mode the reference's full-graph models use, ref ``gcnconv.py:53-58``).
        ``graph`` is the full :class:`~dgll_tpu.graph.Graph` (device-resident)."""
        from dgll_tpu.train.exact_infer import exact_predict

        return exact_predict(self.model.apply, state.params, graph, feats,
                             nodes, feat_dtype=self._feat_dtype)

    def evaluate_nodes_exact(self, state: TrainState, graph, feats, labels_np,
                             nodes) -> float:
        nodes = np.asarray(nodes, np.int64)
        if len(nodes) == 0:
            return 0.0
        pred = self.predict_nodes_exact(state, graph, feats, nodes)
        return float((pred == np.asarray(labels_np)[nodes]).mean())


class DeviceDPEpochRunner(DeviceEpochRunner):
    """Data-parallel :class:`DeviceEpochRunner`: per-device on-device sampling +
    psum'd gradients over a mesh axis. Pass the mesh; the global batch is
    ``mesh.shape[axis] * per_device_batch``."""

    def __init__(
        self,
        model,
        optimizer,
        csr: DeviceCSR,
        fanouts: Sequence[int],
        per_device_batch: int,
        train_nodes,
        mesh,
        loss_fn: Callable = masked_nll_loss,
        seed: int = 0,
        feat_dtype=None,
        window: bool = False,
        axis: str = "data",
        sampler: str = "neighbor",
    ):
        D = int(mesh.shape[axis])
        super().__init__(model, optimizer, csr, fanouts,
                         batch_size=D * int(per_device_batch),
                         train_nodes=train_nodes, loss_fn=loss_fn, seed=seed,
                         feat_dtype=feat_dtype, window=window, sampler=sampler)
        # replace the single-device epoch with the shard_map DP one
        self.epoch_fn = make_device_dp_epoch_fn(
            mesh, self.fanouts, int(per_device_batch), self.n_batches,
            loss_fn, feat_dtype, window, axis, sampler,
        )
        self.mesh = mesh

    def init_state(self, feats) -> TrainState:
        # the epoch returns the state replicated over the mesh; a first state
        # placed any other way would make the second epoch compile again
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(super().init_state(feats),
                              NamedSharding(self.mesh, P()))
