"""Fastest single-chip path: fully device-resident minibatch GraphSAGE.

The graph CSR, features, and labels live in device memory; neighbour sampling
happens inside the jitted program (block-window mode), and each epoch is ONE
dispatch (``lax.scan`` over batches). This is the pipeline behind bench.py's
headline number.

Run: ``python examples/device_pipeline_sage.py`` (any backend; meant for the GPU).
Equivalent CLI: ``python -m dgll_tpu.run --Model SAGE --device_sampling ...``.
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import optax

from dgll_tpu.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu.nn import GraphSAGE
from dgll_tpu.sampling import DeviceCSR
from dgll_tpu.train import DeviceEpochRunner, MiniBatchTrainer
from dgll_tpu.dataloader import DataLoader
from dgll_tpu.sampling import NeighborSampler


def main():
    g = gcn_normalize(synthetic_classification_graph(
        n_node=20_000, avg_degree=10, n_class=8, feat_dim=64, seed=0))
    csr = DeviceCSR.from_graph(g)
    feats = jnp.asarray(g.node_feat)
    labels = jnp.asarray(g.labels)

    model = GraphSAGE(hidden=128, n_class=8, dropout=0.0)
    runner = DeviceEpochRunner(
        model, optax.adam(1e-2), csr, fanouts=[10, 5], batch_size=512,
        train_nodes=g.get_train_nodes(), window=True, seed=0)
    state = runner.init_state(feats)

    for epoch in range(10):
        state, loss = runner.run_epoch(state, feats, labels)
        print(f"epoch {epoch}: loss {float(loss):.4f}")

    # evaluation reuses the host-sampled block evaluator (same TrainState)
    ev = MiniBatchTrainer(model, optax.adam(1e-2))
    test_loader = DataLoader(g, g.get_test_nodes(), NeighborSampler([10, 5]),
                             512, shuffle=False)
    acc = ev.evaluate_nodes(state, test_loader, feats, labels)
    print(f"test accuracy: {acc:.4f}")


if __name__ == "__main__":
    main()
