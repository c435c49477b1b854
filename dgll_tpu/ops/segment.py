"""Segment reductions — the JAX replacement for ``torch_scatter``.

The reference's global pooling (``/root/reference/dgll/nn/GlobalPooling/Pooling.py:18-115``)
and sparse-GAT normalisation lean on ``torch_scatter.scatter``; the JAX form is
``jax.ops.segment_*``, which XLA lowers to scatter reductions (atomic adds on a GPU)
that fuse with the surrounding elementwise work. All ops here take static ``num_segments`` so they jit cleanly.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def segment_sum(data: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)


def segment_mean(data: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    tot = jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)
    cnt = jax.ops.segment_sum(
        jnp.ones((data.shape[0],), dtype=data.dtype), segment_ids, num_segments=num_segments
    )
    return tot / jnp.maximum(cnt, 1.0)[(...,) + (None,) * (data.ndim - 1)]


def segment_max(data: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    """Max per segment; empty segments yield 0 (matching scatter-max-with-zeros semantics)."""
    out = jax.ops.segment_max(data, segment_ids, num_segments=num_segments)
    cnt = jax.ops.segment_sum(
        jnp.ones((data.shape[0],), jnp.float32), segment_ids, num_segments=num_segments
    )
    empty = (cnt == 0)[(...,) + (None,) * (data.ndim - 1)]
    return jnp.where(empty, jnp.zeros_like(out), out)


def segment_min(data: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    out = jax.ops.segment_min(data, segment_ids, num_segments=num_segments)
    cnt = jax.ops.segment_sum(
        jnp.ones((data.shape[0],), jnp.float32), segment_ids, num_segments=num_segments
    )
    empty = (cnt == 0)[(...,) + (None,) * (data.ndim - 1)]
    return jnp.where(empty, jnp.zeros_like(out), out)


def segment_softmax(
    logits: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Numerically-stable softmax within segments (GAT edge-softmax building block).

    Replaces the reference's dense masked softmax (``dgll/nn/Convolution/gatconv.py:36-39``)
    and sparse ``SpecialSpmm`` row-normalisation (``gatconv.py:129-141``) with one
    segment-reduced form that works on edge lists.
    """
    if mask is not None:
        logits = jnp.where(mask, logits, -jnp.inf)
    seg_max = jax.ops.segment_max(logits, segment_ids, num_segments=num_segments)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    logits = logits - seg_max[segment_ids]
    unnorm = jnp.where(jnp.isfinite(logits), jnp.exp(logits), 0.0)
    denom = jax.ops.segment_sum(unnorm, segment_ids, num_segments=num_segments)
    return unnorm / jnp.maximum(denom, 1e-16)[segment_ids]
