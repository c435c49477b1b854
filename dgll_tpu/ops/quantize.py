"""Feature quantization / binarization.

The reference architecture's "Quantization/Binarization" block (README / drawio —
SURVEY.md §0 lists it in the capability surface). Features are stored int8 (or
sign-binarized) with per-column scales; dequantisation fuses into the post-gather
compute under jit. Quadruples the device feature-cache capacity and quarters gather
traffic on byte-bound paths. Stochastic rounding draws its noise with ``jax.random``.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dgll_tpu.utils import struct


@struct.dataclass
class QuantizedFeatures:
    values: jax.Array    # [N, D] int8
    scale: jax.Array     # [D] float32 (per-column)
    n: int = struct.field(pytree_node=False, default=0)
    d: int = struct.field(pytree_node=False, default=0)

    def gather(self, ids, dtype=jnp.float32) -> jax.Array:
        q = jnp.take(self.values, ids, axis=0)
        return q.astype(dtype) * self.scale.astype(dtype)[None, :]

    def dequantize(self, dtype=jnp.float32) -> jax.Array:
        return self.values.astype(dtype) * self.scale.astype(dtype)[None, :]


def quantize_int8(x, stochastic: bool = False, seed: int = 0) -> QuantizedFeatures:
    """Per-column symmetric int8 quantisation (host or device input)."""
    x = jnp.asarray(x, jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(x), axis=0), 1e-12) / 127.0
    y = x / scale[None, :]
    if stochastic:
        key = jax.random.key(seed)
        y = y + jax.random.uniform(key, y.shape, minval=-0.5, maxval=0.5)
    q = jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8)
    return QuantizedFeatures(values=q, scale=scale, n=int(x.shape[0]), d=int(x.shape[1]))


def binarize(x) -> Tuple[jax.Array, jax.Array]:
    """Sign binarization with per-column mean-magnitude scale (XNOR-style).

    Returns (signs int8 in {-1, +1}, scale [D]); reconstruct as ``signs * scale``.
    """
    x = jnp.asarray(x, jnp.float32)
    scale = jnp.mean(jnp.abs(x), axis=0)
    signs = jnp.where(x >= 0, 1, -1).astype(jnp.int8)
    return signs, scale


def quantization_error(x, qf: QuantizedFeatures) -> float:
    x = jnp.asarray(x, jnp.float32)
    err = jnp.abs(qf.dequantize() - x)
    return float(jnp.mean(err) / jnp.maximum(jnp.mean(jnp.abs(x)), 1e-12))
