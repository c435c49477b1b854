"""Data-parallel minibatch training over the mesh.

Replaces the reference's DDP + RaCoM async gradient queues
(``/root/reference/dgll/GPU Accelerator/MQGCN.py:55-90,100-163``): one jitted step with
the global batch sharded over the ``data`` axis and an explicit ``psum`` gradient
reduction inside ``shard_map``. XLA's latency-hiding scheduler overlaps the gradient
collective with backward compute — the compiler-level version of RaCoM's
comm/compute decoupling, without staleness.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dgll_tpu.sampling.base import Block, HostGraph
from dgll_tpu.train.metrics import masked_nll_loss


def stack_block_lists(block_lists: Sequence[List[Block]]) -> List[Block]:
    """Stack per-device block lists (same static shapes) on a new leading device axis."""
    n_layer = len(block_lists[0])
    return [
        jax.tree.map(lambda *xs: jnp.stack(xs), *[bl[i] for bl in block_lists])
        for i in range(n_layer)
    ]


class ShardedDataLoader:
    """Samples ``n_shard`` per-device sub-batches per step and stacks them.

    Per-rank seed sharding parity with the reference's ``use_ddp=True`` loader
    (``MQGCN.py:114-137``), single-controller style.
    """

    def __init__(self, host_g: HostGraph, seeds, sampler, per_device_batch: int,
                 n_shard: int, shuffle: bool = True, seed: int = 0, features=None,
                 labels=None):
        self.host_g = host_g
        self.seeds = np.asarray(seeds, np.int64)
        self.sampler = sampler
        self.b = int(per_device_batch)
        self.n_shard = int(n_shard)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.seeds) // (self.b * self.n_shard)

    def __iter__(self):
        order = (
            self._rng.permutation(len(self.seeds)) if self.shuffle else np.arange(len(self.seeds))
        )
        seeds = self.seeds[order]
        step_span = self.b * self.n_shard
        for i in range(len(self)):
            chunk = seeds[i * step_span : (i + 1) * step_span]
            lists, outs = [], []
            for d in range(self.n_shard):
                sub = chunk[d * self.b : (d + 1) * self.b]
                _, out, blocks = self.sampler.sample(self.host_g, sub, pad_to=self.b)
                lists.append(blocks)
                outs.append(out)
            yield np.stack(outs), stack_block_lists(lists)


def make_dp_block_step(
    mesh: Mesh,
    model_apply: Callable,
    tx: optax.GradientTransformation,
    axis: str = "data",
    loss_fn=masked_nll_loss,
):
    """Jitted DP step: params replicated, stacked blocks/features sharded on dim 0.

    ``model_apply(params, blocks, x, rng) -> log-probs`` for ONE device's sub-batch;
    the step runs it per device under shard_map and psums loss+grads.
    """

    def device_step(params, blocks, x, labels, mask, rng):
        # strip the leading device axis of size 1 from every leaf
        blocks = jax.tree.map(lambda a: a[0], blocks,
                              is_leaf=lambda a: isinstance(a, jax.Array))
        x, labels, mask = x[0], labels[0], mask[0]

        def loss_of(p):
            logp = model_apply(p, blocks, x, rng)
            return loss_fn(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(params)
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        return loss, grads

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, blocks, x, labels, mask, rng):
        sharded = partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), jax.tree.map(lambda _: P(axis), blocks,
                                        is_leaf=lambda a: isinstance(a, jax.Array)),
                      P(axis), P(axis), P(axis), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        loss, grads = sharded(device_step)(params, blocks, x, labels, mask, rng)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    return step


def make_async_dp_block_step(
    mesh: Mesh,
    model_apply: Callable,
    tx: optax.GradientTransformation,
    axis: str = "data",
    loss_fn=masked_nll_loss,
):
    """One-step-stale DP step — the compiler-scheduled equivalent of RaCoM's async
    gradient queues (``MQGCN.py:55-79``): step k computes its gradients but applies
    step k-1's, so the gradient ``pmean`` collective overlaps the next forward/backward
    under XLA's latency-hiding scheduler (bounded staleness = 1, like the reference's
    bounded ``gradient_buffer``).

    Usage: carry ``prev_grads`` across steps (init with ``init_grads``); after the
    final batch, apply the returned grads once more to flush.
    """

    def device_step(params, blocks, x, labels, mask, rng):
        blocks = jax.tree.map(lambda a: a[0], blocks,
                              is_leaf=lambda a: isinstance(a, jax.Array))
        x, labels, mask = x[0], labels[0], mask[0]

        def loss_of(p):
            logp = model_apply(p, blocks, x, rng)
            return loss_fn(logp, labels, mask)

        loss, grads = jax.value_and_grad(loss_of)(params)
        return jax.lax.pmean(loss, axis), jax.lax.pmean(grads, axis)

    def init_grads(params):
        return jax.tree.map(jnp.zeros_like, params)

    @partial(jax.jit, donate_argnums=(0, 1, 2))
    def step(params, opt_state, prev_grads, blocks, x, labels, mask, rng):
        # apply the stale gradients first; their collective finished last step
        updates, opt_state2 = tx.update(prev_grads, opt_state, params)
        params2 = optax.apply_updates(params, updates)
        sharded = partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), jax.tree.map(lambda _: P(axis), blocks,
                                        is_leaf=lambda a: isinstance(a, jax.Array)),
                      P(axis), P(axis), P(axis), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        loss, grads = sharded(device_step)(params2, blocks, x, labels, mask, rng)
        return params2, opt_state2, grads, loss

    return step, init_grads
