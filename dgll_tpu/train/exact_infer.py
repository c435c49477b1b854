"""Exact (full-neighborhood) inference for minibatch-trained models.

The reference's full-graph models evaluate exactly (``/root/reference/dgll/nn/
Convolution/gcnconv.py:53-58``, ``Evaluation/PPI/train_gcn.py:29-57``) while its
minibatch trainers validate through the sampler — accuracy numbers inherit
sampling noise. Here every model's ``__call__`` accepts a full :class:`Graph`
for all layers (``nn/models.py:_layer_inputs``), so exact inference is ONE
compiled full-graph forward with the minibatch-trained parameters: each layer
aggregates over the COMPLETE in-neighborhood through the XLA segment ops. This
is the sampling-noise-free eval mode.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=32)
def make_exact_logits_fn(apply_fn, feat_dtype=None):
    """``f(params, graph, feats) -> log-probs [n_node, C]`` — jitted once.

    ``graph`` is a pytree argument, so one compile serves
    any graph of the same static shape. Cached per (apply_fn, dtype) so
    repeated ``exact_predict`` calls hit the same jit cache (``Module``s are
    frozen dataclasses — their bound ``apply`` hashes stably)."""

    @jax.jit
    def f(params, graph, feats):
        x = jnp.asarray(feats)
        if feat_dtype is not None:
            x = x.astype(feat_dtype)
        return apply_fn({"params": params}, graph, x, deterministic=True)

    return f


def exact_predict(
    apply_fn,
    params,
    graph,
    feats,
    nodes: Optional[np.ndarray] = None,
    feat_dtype=None,
) -> np.ndarray:
    """Argmax class per node via the exact full-graph forward.

    Returns predictions for ``nodes`` (default: every real node). One device
    dispatch + one [n] D2H transfer."""
    logp = make_exact_logits_fn(apply_fn, feat_dtype)(params, graph, feats)
    pred = jnp.argmax(logp, axis=-1).astype(jnp.int32)
    pred = np.asarray(pred)[: graph.n_real_node]
    if nodes is None:
        return pred
    return pred[np.asarray(nodes, np.int64)]


def exact_accuracy(apply_fn, params, graph, feats, labels_np, nodes,
                   feat_dtype=None) -> float:
    """Accuracy over ``nodes`` through exact inference."""
    nodes = np.asarray(nodes, np.int64)
    if len(nodes) == 0:
        return 0.0
    pred = exact_predict(apply_fn, params, graph, feats, nodes, feat_dtype)
    return float((pred == np.asarray(labels_np)[nodes]).mean())
