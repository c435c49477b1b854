"""Training loops: jitted steps + epoch drivers for full-batch and minibatch GNNs.

Replaces the reference's per-script training loops (``graphage.py:50-97``,
``GPU Accelerator/buffer_queues.py:74-119``, ``CommGNN_train.py:121-159``) with two
reusable drivers:

* ``FullBatchTrainer`` — whole-graph forward/backward as a single jitted step.
* ``MiniBatchTrainer`` — consumes a ``DataLoader`` of sampled blocks; host sampling is
  overlapped with device compute by the loader's prefetch thread + JAX async dispatch
  (the XLA equivalent of MQ-GNN's producer/consumer streams).

Both support validation-plateau early stopping (``n_stops``-style,
ref ``CommGNN_train.py:147-153``) and per-phase wall-clock stats.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dgll_tpu.train.metrics import accuracy, masked_nll_loss
from dgll_tpu.utils import struct


@struct.dataclass
class TrainState:
    """Step count, parameters and optimizer state; the model's ``apply`` and the
    optax transformation ride along as static fields."""

    step: Any
    params: Any
    opt_state: Any
    apply_fn: Callable = struct.field(pytree_node=False)
    tx: optax.GradientTransformation = struct.field(pytree_node=False)

    @classmethod
    def create(cls, *, apply_fn: Callable, params: Any,
               tx: optax.GradientTransformation) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params),
                   apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, *, grads: Any) -> "TrainState":
        """One optimizer update: ``tx.update`` then ``optax.apply_updates``."""
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)


def create_train_state(model, rng, optimizer, *init_args, **init_kw) -> TrainState:
    params = model.init(rng, *init_args, **init_kw)["params"]
    return TrainState.create(apply_fn=model.apply, params=params, tx=optimizer)


def make_full_batch_step(loss_fn=masked_nll_loss):
    """Jitted (donated) full-batch train step: state, graph, x, labels, mask -> state, loss."""

    @jax.jit
    def step(state: TrainState, g, x, labels, mask, dropout_rng):
        def loss_of(params):
            logp = state.apply_fn(
                {"params": params}, g, x, deterministic=False,
                rngs={"dropout": dropout_rng},
            )
            return loss_fn(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        return state.apply_gradients(grads=grads), loss

    return step


def make_full_batch_eval():
    @jax.jit
    def evaluate(state: TrainState, g, x):
        return state.apply_fn({"params": state.params}, g, x, deterministic=True)

    return evaluate


def make_block_step(loss_fn=masked_nll_loss):
    """Jitted minibatch step over sampled blocks.

    ``x`` are gathered input features [n_src_0, d]; labels/mask are for the padded
    seed batch. Blocks are pytrees, so shapes are static across batches and this
    compiles exactly once.
    """

    @jax.jit
    def step(state: TrainState, blocks, x, labels, mask, dropout_rng):
        def loss_of(params):
            logp = state.apply_fn(
                {"params": params}, list(blocks), x, deterministic=False,
                rngs={"dropout": dropout_rng},
            )
            return loss_fn(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        return state.apply_gradients(grads=grads), loss

    return step


def blocks_from_packed(ids, mask, fanouts):
    """Rebuild the outermost-first Block list from the frontier-growth buffers
    (``NeighborSampler.sample_packed``) — pure static slicing, zero data
    movement, safe inside jit. ``ids``/``mask`` are [n_final]; the batch size is
    implied by the growth: sizes[k+1] = sizes[k] * (1 + reversed(fanouts)[k])."""
    from dgll_tpu.sampling.base import Block

    fanouts = [int(f) for f in fanouts]
    total_grow = 1
    for f in fanouts:
        total_grow *= 1 + f
    b = ids.shape[0] // total_grow
    mask_b = mask.astype(bool)
    blocks = []
    n_k = b
    for f in reversed(fanouts):
        n_next = n_k * (1 + f)
        blocks.insert(0, Block(
            dst_ids=ids[:n_k],
            src_ids=ids[:n_next],
            neigh_mask=mask_b[n_k:n_next].reshape(n_k, f),
            dst_mask=mask_b[:n_k],
            fanout=f,
            n_dst=int(n_k),
        ))
        n_k = n_next
    return blocks


def make_packed_block_step(fanouts, loss_fn=masked_nll_loss):
    """Jitted minibatch step over the PACKED batch form: the host ships only
    ``(ids, mask)`` (2 transfers/batch instead of 8 block leaves + 2 gathers);
    blocks are rebuilt and features/labels gathered inside the program.
    ``feats``/``labels`` must be device-resident full arrays."""

    fanouts = [int(f) for f in fanouts]

    @jax.jit
    def step(state: TrainState, ids, mask, feats, labels, dropout_rng):
        blocks = blocks_from_packed(ids, mask, fanouts)
        x = jnp.take(feats, blocks[0].src_ids, axis=0)
        y = jnp.take(labels, blocks[-1].dst_ids, axis=0)

        def loss_of(params):
            logp = state.apply_fn(
                {"params": params}, blocks, x, deterministic=False,
                rngs={"dropout": dropout_rng},
            )
            return loss_fn(logp, y, blocks[-1].dst_mask)

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        return state.apply_gradients(grads=grads), loss

    return step


def make_packed_group_step(fanouts, loss_fn=masked_nll_loss):
    """G packed train steps in ONE dispatch: ``(ids [G, n], mask [G, n])``
    scanned inside the program — 2 H2D transfers and 1 dispatch per G batches.

    The reference hides its producer latency with CUDA streams + queues
    (``buffer_queues.py:22-119``); the XLA form is to amortise the per-batch
    dispatch and host round-trip over a scanned group. Ragged tails are padded
    with all-zero-mask batches — those contribute zero loss and their optimizer
    update is suppressed entirely (state passes through unchanged), so results
    are bit-identical to ungrouped stepping with the same dropout keys.
    """
    fanouts = [int(f) for f in fanouts]

    @jax.jit
    def steps(state: TrainState, ids_g, mask_g, feats, labels, dropout_rng):
        def body(carry, batch):
            st, key = carry
            ids, mask = batch
            key, drng = jax.random.split(key)
            blocks = blocks_from_packed(ids, mask, fanouts)
            x = jnp.take(feats, blocks[0].src_ids, axis=0)
            y = jnp.take(labels, blocks[-1].dst_ids, axis=0)

            def loss_of(params):
                logp = st.apply_fn(
                    {"params": params}, blocks, x, deterministic=False,
                    rngs={"dropout": drng},
                )
                return loss_fn(logp, y, blocks[-1].dst_mask)

            loss, grads = jax.value_and_grad(loss_of)(st.params)
            valid = jnp.any(mask)
            st2 = st.apply_gradients(grads=grads)
            # padding batches must not touch the state (adam moves on zero
            # grads otherwise)
            st2 = jax.tree.map(lambda a, b: jnp.where(valid, a, b), st2, st)
            return (st2, key), (jnp.where(valid, loss, 0.0),
                                valid.astype(jnp.float32))

        (state2, _), (losses, valids) = jax.lax.scan(
            body, (state, dropout_rng), (ids_g, mask_g)
        )
        return state2, losses.sum(), valids.sum()

    return steps


def make_scanned_block_step(loss_fn=masked_nll_loss):
    """K training steps in ONE dispatch: batches stacked on a leading axis and
    consumed by ``lax.scan`` (blocks share static shapes, so this compiles once).

    The XLA form of MQ-GNN's batch pipelining (``buffer_queues.py``): instead
    of hiding per-batch launch latency with CUDA streams, K jitted steps fuse
    into one XLA program — one host round-trip per K batches. Returns
    ``(state, losses [K])``.
    """

    @jax.jit
    def steps(state: TrainState, blocks_k, x_k, labels_k, mask_k, dropout_rng):
        def body(carry, batch):
            st, key = carry
            blocks, x, y, m = batch
            key, drng = jax.random.split(key)

            def loss_of(params):
                logp = st.apply_fn(
                    {"params": params}, list(blocks), x, deterministic=False,
                    rngs={"dropout": drng},
                )
                return loss_fn(logp, y, m)

            loss, grads = jax.value_and_grad(loss_of)(st.params)
            return (st.apply_gradients(grads=grads), key), loss

        (state2, _), losses = jax.lax.scan(
            body, (state, dropout_rng), (blocks_k, x_k, labels_k, mask_k)
        )
        return state2, losses

    return steps


def stack_batches(batches):
    """Stack K same-shape (blocks, x, y, mask) batches on a new leading axis for
    ``make_scanned_block_step`` (static block fields must match across batches)."""
    blocks_k = jax.tree.map(lambda *xs: jnp.stack(xs), *[b[0] for b in batches])
    x_k = jnp.stack([b[1] for b in batches])
    y_k = jnp.stack([b[2] for b in batches])
    m_k = jnp.stack([b[3] for b in batches])
    return blocks_k, x_k, y_k, m_k


def make_block_eval():
    @jax.jit
    def evaluate(state: TrainState, blocks, x):
        return state.apply_fn({"params": state.params}, list(blocks), x, deterministic=True)

    return evaluate


@dataclass
class EpochStats:
    epoch: int
    loss: float
    seconds: float
    val_metric: Optional[float] = None


@dataclass
class History:
    epochs: List[EpochStats] = field(default_factory=list)
    best_val: float = -np.inf
    best_params: Any = None

    def improved(self, v: float) -> bool:
        if v > self.best_val:
            self.best_val = v
            return True
        return False


class FullBatchTrainer:
    def __init__(self, model, optimizer, loss_fn=masked_nll_loss, seed: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = make_full_batch_step(loss_fn)
        self.evaluate = make_full_batch_eval()
        self.rng = jax.random.key(seed)

    def fit(
        self,
        g,
        x,
        labels,
        train_mask,
        val_mask=None,
        epochs: int = 100,
        patience: int = 0,
        log_every: int = 0,
        state: Optional[TrainState] = None,
    ):
        # one batched host->device transfer for graph + features + targets
        g, x, labels, train_mask, val_mask = jax.block_until_ready(
            jax.tree.map(jnp.asarray, (g, x, labels, train_mask, val_mask))
        )
        self.rng, init_rng = jax.random.split(self.rng)
        if state is None:
            state = create_train_state(self.model, init_rng, self.optimizer, g, x)
        hist = History()
        bad = 0
        # Only force a D2H sync per epoch when something host-side consumes the
        # value (validation early-stop or logging); otherwise epochs dispatch
        # back-to-back and the single sync happens at the end.
        sync_each = val_mask is not None or bool(log_every)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            self.rng, drng = jax.random.split(self.rng)
            state, loss = self.step(state, g, x, labels, train_mask, drng)
            if sync_each:
                loss = float(loss)
            dt = time.perf_counter() - t0
            val = None
            if val_mask is not None:
                logp = self.evaluate(state, g, x)
                val = accuracy(logp, labels, val_mask)
                if hist.improved(val):
                    hist.best_params = state.params
                    bad = 0
                else:
                    bad += 1
            hist.epochs.append(EpochStats(epoch, loss, dt, val))
            if log_every and epoch % log_every == 0:
                print(f"epoch {epoch:4d} loss {loss:.4f} val {val}")
            if patience and bad >= patience:
                break
        if not sync_each:
            for e in hist.epochs:
                e.loss = float(e.loss)
        return state, hist


def measure_link(device=None, size_bytes: int = 4 << 20) -> tuple:
    """One-shot H2D link probe: ``(bandwidth_bytes_per_s, dispatch_rtt_s)``.

    The reference hides its producer cost behind CUDA streams no matter what
    that cost is (``buffer_queues.py:22-119``). Where the host->device link
    itself is the bottleneck, batching dispatches HURTS instead. This probe
    feeds :func:`choose_packed_group` so the runtime routes by measurement
    instead of shipping a silently-regressing path.
    """
    import numpy as np

    dev = device if device is not None else jax.devices()[0]
    buf = np.ones(size_bytes // 4, np.float32)
    jax.block_until_ready(jax.device_put(buf, dev))  # warm (allocator, path)

    # RTT first: the transfer probe's value read pays one dispatch RTT too,
    # which must be subtracted or bandwidth is understated by up to ~rtt/t —
    # on fast-bandwidth/high-RTT links that bias would mis-route grouping
    # (the exact regime auto-grouping exists for).
    one = jax.device_put(np.zeros(8, np.float32), dev)
    f = jax.jit(lambda v: jnp.sum(v))
    float(f(one))  # compile outside the timed window
    t0 = time.perf_counter()
    n = 4
    for _ in range(n):
        float(f(one))
    rtt = (time.perf_counter() - t0) / n

    t0 = time.perf_counter()
    x = jax.device_put(buf, dev)
    float(jnp.sum(x[:8]))  # value read: the transfer has arrived
    bw = size_bytes / max(time.perf_counter() - t0 - rtt, 1e-6)
    return bw, rtt


def choose_packed_group(payload_bytes: int, bandwidth: float, rtt: float,
                        max_group: int = 8) -> int:
    """Group size for the packed epoch, from measured link characteristics.

    Grouping scans G batches per dispatch, saving ~(G-1) dispatch RTTs per
    group — a win only when the fixed RTT dominates the per-batch H2D payload
    time. On a bandwidth-bound link the payload time dwarfs the RTT, grouping
    buys nothing and costs pipeline overlap, so route to group=1 there.
    """
    transfer_s = payload_bytes / max(bandwidth, 1.0)
    if transfer_s >= rtt:
        return 1          # bandwidth-bound: RTT amortisation cannot win
    # RTT-bound: amortise until the grouped payload time reaches ~1 RTT
    g = int(min(max_group, max(1.0, rtt / max(transfer_s, 1e-9))))
    return max(g, 1)


class MiniBatchTrainer:
    def __init__(self, model, optimizer, loss_fn=masked_nll_loss, seed: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.step = make_block_step(loss_fn)
        self.evaluate = make_block_eval()
        self.rng = jax.random.key(seed)

    def init_state(self, blocks, x) -> TrainState:
        self.rng, init_rng = jax.random.split(self.rng)
        return create_train_state(self.model, init_rng, self.optimizer, list(blocks), x)

    def run_epoch(self, state: TrainState, loader, features, labels,
                  fetch_fn: Optional[Callable] = None) -> tuple:
        """One epoch over the loader. ``features``/``labels`` are full [N, d]/[N] arrays
        (device-resident); per-batch gathers happen on device from block ids.
        ``fetch_fn(src_ids) -> [n_src, d]`` overrides the feature gather (e.g. an
        ``HBMFeatureCache.fetch`` serving hits from HBM and misses from the host).
        Cache fetches are pipelined one batch ahead on a worker thread, so the host
        gather of batch k+1 overlaps the device step of batch k (the XLA form of
        the reference's non_blocking H2D streams, ``storage.py:151-198``)."""
        features, labels = jax.tree.map(jnp.asarray, (features, labels))
        # The loss total stays a device-side scalar until ONE sync at epoch end:
        # a per-batch host<->device round trip (float(loss)) would serialise
        # the host loop behind the device. Memory stays bounded because
        # the device executes steps in order (queued programs hold no output
        # buffers) and the loader's host-side sampling is natural backpressure.
        # A running scalar add — not jnp.stack at epoch end — keeps the
        # epilogue's compiled shape independent of epoch length.
        total, nb = None, 0
        t0 = time.perf_counter()
        if fetch_fn is None:
            for inp, out, blocks in loader:
                x = jnp.take(features, blocks[0].src_ids, axis=0)
                y = jnp.take(labels, blocks[-1].dst_ids, axis=0)
                self.rng, drng = jax.random.split(self.rng)
                state, loss = self.step(state, tuple(blocks), x, y,
                                        blocks[-1].dst_mask, drng)
                total = loss if total is None else total + loss
                nb += 1
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(1) as ex:
                it = iter(loader)
                cur = next(it, None)
                fut = None if cur is None else ex.submit(fetch_fn, cur[2][0].src_ids)
                while cur is not None:
                    inp, out, blocks = cur
                    x = fut.result()
                    cur = next(it, None)
                    if cur is not None:
                        fut = ex.submit(fetch_fn, cur[2][0].src_ids)
                    y = jnp.take(labels, blocks[-1].dst_ids, axis=0)
                    self.rng, drng = jax.random.split(self.rng)
                    state, loss = self.step(state, tuple(blocks), x, y,
                                            blocks[-1].dst_mask, drng)
                    total = loss if total is None else total + loss
                    nb += 1
        total = float(total) if total is not None else 0.0
        return state, total / max(nb, 1), time.perf_counter() - t0

    def run_epoch_packed(self, state: TrainState, loader, features, labels,
                         fanouts, group=1) -> tuple:
        """One epoch over a ``packed=True`` loader: each batch is just
        ``(ids, mask)``; blocks are rebuilt and features gathered inside the
        jitted step (2 H2D transfers + 1 dispatch per batch — the
        transfer-minimal host pipeline).

        ``group > 1`` scans ``group`` batches per dispatch
        (:func:`make_packed_group_step`), dividing the fixed dispatch/RTT cost
        by the group size; the tail group is padded with zero-mask batches
        whose updates are suppressed, so training math is unchanged.

        ``group="auto"`` probes the link once (:func:`measure_link`) and picks
        the group from the measured bandwidth/RTT and the first batch's
        payload (:func:`choose_packed_group`) — grouped dispatch regresses
        badly on bandwidth-bound links, so it must never be the blind default. The chosen size is recorded in
        ``self.last_group``.
        """
        features, labels = jax.tree.map(jnp.asarray, (features, labels))
        if group == "auto":
            import itertools

            it = iter(loader)
            first = next(it, None)
            if first is None:
                self.last_group = 1
                return state, 0.0, 0.0
            payload = first[0].nbytes + first[1].nbytes
            if not hasattr(self, "_link"):
                self._link = measure_link()
            bw, rtt = self._link
            group = choose_packed_group(payload, bw, rtt)
            loader = itertools.chain([first], it)
        self.last_group = group = int(group)
        if not hasattr(self, "_packed_steps"):
            self._packed_steps = {}
        key = (tuple(int(f) for f in fanouts), int(group))
        if key not in self._packed_steps:
            self._packed_steps[key] = (
                make_packed_group_step(key[0], self.loss_fn) if group > 1
                else make_packed_block_step(key[0], self.loss_fn))
        step = self._packed_steps[key]
        total, nb = None, 0
        t0 = time.perf_counter()
        if group > 1:
            buf = []
            nb = None  # device scalar once set; None-check only (no == on jax.Array)

            def flush(state, total, nb):
                ids_g = np.stack([b[0] for b in buf])
                mask_g = np.stack([b[1] for b in buf])
                self.rng, drng = jax.random.split(self.rng)
                state, lsum, nvalid = step(state, jnp.asarray(ids_g),
                                           jnp.asarray(mask_g), features,
                                           labels, drng)
                # accumulate on DEVICE — a float() (or any truthiness test of a
                # device scalar) here would sync every group and re-serialize
                # the dispatch pipeline
                total = lsum if total is None else total + lsum
                nb = nvalid if nb is None else nb + nvalid
                return state, total, nb

            for ids, mask in loader:
                buf.append((np.asarray(ids), np.asarray(mask)))
                if len(buf) == group:
                    state, total, nb = flush(state, total, nb)
                    buf = []
            if buf:
                pad = group - len(buf)
                z = (np.zeros_like(buf[0][0]), np.zeros_like(buf[0][1]))
                buf.extend([z] * pad)
                state, total, nb = flush(state, total, nb)
            total = float(total) if total is not None else 0.0
            nb = float(nb) if nb is not None else 0.0
            return state, total / max(nb, 1.0), time.perf_counter() - t0
        for ids, mask in loader:
            self.rng, drng = jax.random.split(self.rng)
            state, loss = step(state, jnp.asarray(ids), jnp.asarray(mask),
                               features, labels, drng)
            total = loss if total is None else total + loss
            nb += 1
        total = float(total) if total is not None else 0.0
        return state, total / max(nb, 1), time.perf_counter() - t0

    def evaluate_nodes(self, state, loader, features, labels,
                       fetch_fn: Optional[Callable] = None) -> float:
        """Sampled evaluation accuracy over the loader's seed nodes."""
        pred, y = self.predict_nodes(state, loader, features, labels, fetch_fn)
        return float((pred == y).mean()) if len(pred) else 0.0

    def predict_nodes(self, state, loader, features, labels,
                      fetch_fn: Optional[Callable] = None):
        """Predicted classes + true labels for every real (unpadded) seed node.

        Returns ``(pred, y)`` 1-D numpy arrays so callers can compute any metric
        (accuracy / micro-F1 / macro-F1 — ref ``record_result_new``,
        ``GPU Accelerator/utils.py:60-91``)."""
        features, labels = jax.tree.map(jnp.asarray, (features, labels))
        preds, ys = [], []
        for inp, out, blocks in loader:
            if fetch_fn is None:
                x = jnp.take(features, blocks[0].src_ids, axis=0)
            else:
                x = fetch_fn(blocks[0].src_ids)
            logp = self.evaluate(state, tuple(blocks), x)
            y = np.asarray(jnp.take(labels, blocks[-1].dst_ids, axis=0))
            m = np.asarray(blocks[-1].dst_mask).astype(bool)
            pred = np.asarray(logp).argmax(-1)
            preds.append(pred[m])
            ys.append(y[m])
        if not preds:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(preds), np.concatenate(ys)
