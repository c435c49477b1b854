"""Skip-gram embedding training (jitted, negative sampling).

Parity with the reference's manual skip-gram (``deepWalk.py:41-52``,
``skipgram.py:3-26`` — full-softmax with hand-rolled SGD); re-designed for the
device: window pairs are generated host-side from the walk matrix, the device step
is one jitted SGNS (skip-gram negative sampling) update over a [B] pair batch — all
dense batched lookups, no [N]-wide softmax.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax


def walk_pairs(walks: np.ndarray, window: int, rng: np.random.Generator) -> np.ndarray:
    """(center, context) pairs from walks with the standard shrinking window."""
    W, L = walks.shape
    pairs = []
    for off in range(1, window + 1):
        keep = rng.random((W, L - off)) < (1.0 - (off - 1) / window)
        c = walks[:, :-off][keep]
        t = walks[:, off:][keep]
        pairs.append(np.stack([c, t], 1))
        pairs.append(np.stack([t, c], 1))
    return np.concatenate(pairs, 0)


class SkipGramModel:
    """Two-matrix SGNS model; ``embeddings`` returns W_in (ref ``SkipGramModel``)."""

    def __init__(self, n_node: int, dim: int, n_negative: int = 5, lr: float = 1e-2,
                 seed: int = 0):
        self.n_node = n_node
        self.dim = dim
        self.n_negative = n_negative
        key = jax.random.key(seed)
        k1, k2 = jax.random.split(key)
        scale = 1.0 / np.sqrt(dim)
        self.params = {
            "w_in": jax.random.uniform(k1, (n_node, dim), jnp.float32, -scale, scale),
            "w_out": jnp.zeros((n_node, dim), jnp.float32),
        }
        self.tx = optax.adam(lr)
        self.opt_state = self.tx.init(self.params)
        self._step = self._build_step()
        self._key = jax.random.key(seed + 1)

    def _build_step(self):
        n_neg = self.n_negative
        n_node = self.n_node
        tx = self.tx

        @jax.jit
        def step(params, opt_state, centers, contexts, key):
            neg = jax.random.randint(key, (centers.shape[0], n_neg), 0, n_node)

            def loss_of(p):
                h = jnp.take(p["w_in"], centers, axis=0)            # [B, D]
                pos = jnp.take(p["w_out"], contexts, axis=0)        # [B, D]
                negv = jnp.take(p["w_out"], neg, axis=0)            # [B, K, D]
                pos_score = jnp.sum(h * pos, -1)
                neg_score = jnp.einsum("bd,bkd->bk", h, negv)
                loss = -jnp.mean(
                    jax.nn.log_sigmoid(pos_score)
                    + jnp.sum(jax.nn.log_sigmoid(-neg_score), -1)
                )
                return loss

            loss, grads = jax.value_and_grad(loss_of)(params)
            updates, opt_state2 = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state2, loss

        return step

    def train(self, pairs: np.ndarray, epochs: int = 1, batch_size: int = 8192,
              seed: int = 0, shuffle: bool = True) -> float:
        rng = np.random.default_rng(seed)
        n = len(pairs)
        bs = min(batch_size, n)
        last = 0.0
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(n // bs):
                batch = pairs[order[i * bs : (i + 1) * bs]]
                self._key, k = jax.random.split(self._key)
                self.params, self.opt_state, loss = self._step(
                    self.params, self.opt_state,
                    jnp.asarray(batch[:, 0], jnp.int32),
                    jnp.asarray(batch[:, 1], jnp.int32), k,
                )
            last = float(loss)
        return last

    @property
    def embeddings(self) -> np.ndarray:
        return np.asarray(self.params["w_in"])

    def node_embedding(self, nodes) -> np.ndarray:
        """ref ``learnNodeEmbedding``."""
        return self.embeddings[np.asarray(nodes)]

    def edge_embedding(self, src, dst) -> np.ndarray:
        """Hadamard edge features (ref ``learnEdgeEmbedding``)."""
        e = self.embeddings
        return e[np.asarray(src)] * e[np.asarray(dst)]


def save_embedding(path: str, emb: np.ndarray) -> None:
    np.save(path, emb)


def load_embedding(path: str) -> np.ndarray:
    return np.load(path)


def plot_embedding(emb: np.ndarray, labels=None, path: str = "embedding.png") -> str:
    """2-D scatter of embeddings (PCA to 2 dims) — parity with the reference's
    ``ge.utils`` plot helper. Saves to ``path``; returns the path. Matplotlib is
    optional — raises a clear error if absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("plot_embedding needs matplotlib") from e

    x = np.asarray(emb, np.float64)
    x = x - x.mean(0)
    # PCA via SVD
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    pts = u[:, :2] * s[:2]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(pts[:, 0], pts[:, 1], c=None if labels is None else np.asarray(labels),
               s=8, cmap="tab10")
    ax.set_title("node embeddings (PCA)")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
