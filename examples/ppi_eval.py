"""PPI-protocol evaluation: multilabel GCN + micro-F1 over per-graph batches —
parity with ``/root/reference/Evaluation/PPI/train_gcn.py:29-57`` (sparse-COO GCN,
100-epoch timing loop, micro-F1) and ``ppi_dataloader.py``.

    python examples/ppi_eval.py                  # synthetic PPI-shaped data
    python examples/ppi_eval.py --data /path/ppi # real {split}_graph.json + .npy files
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import optax

from dgll_tpu.data import gcn_normalize, load_ppi_split
from dgll_tpu.graph import Graph, pad_graph
from dgll_tpu.nn import GCNConv
from dgll_tpu.train.metrics import masked_bce_loss, micro_f1


def synthetic_ppi(n_graph=4, n_node=600, avg_deg=8, feat_dim=50, n_label=121, seed=0):
    """PPI-shaped multilabel graphs (the real blobs are absent from the reference
    snapshot and this environment has no egress)."""
    rng = np.random.default_rng(seed)
    graphs = []
    # ONE shared feature->label mapping so train graphs transfer to the test graph
    w = rng.standard_normal((feat_dim, n_label), dtype=np.float32)
    for g_i in range(n_graph):
        src = rng.integers(0, n_node, n_node * avg_deg)
        dst = rng.integers(0, n_node, n_node * avg_deg)
        feats = rng.standard_normal((n_node, feat_dim), dtype=np.float32)
        labels = ((feats @ w) > 0.8).astype(np.float32)
        graphs.append(Graph.from_edges(src, dst, n_node, node_feat=feats,
                                       labels=labels, make_bidirected=True,
                                       add_self_loops=True))
    return graphs


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="", help="dir with {split}_graph.json + .npy")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=256)
    args = p.parse_args()

    if args.data:
        train_graphs = load_ppi_split(args.data, "train")
        test_graphs = load_ppi_split(args.data, "test")
    else:
        graphs = synthetic_ppi()
        train_graphs, test_graphs = graphs[:-1], graphs[-1:]

    n_label = int(np.asarray(train_graphs[0].labels).shape[1])
    # pad all graphs to one static shape -> the train step compiles once
    max_n = max(g.n_node for g in train_graphs + test_graphs)
    max_e = max(g.n_edge for g in train_graphs + test_graphs)
    train_graphs = [
        gcn_normalize(pad_graph(g, node_multiple=max_n + 8, edge_multiple=max_e + 128))
        for g in train_graphs
    ]
    test_graphs = [
        gcn_normalize(pad_graph(g, node_multiple=max_n + 8, edge_multiple=max_e + 128))
        for g in test_graphs
    ]

    from dgll_tpu.nn.module import Module

    class PPIModel(Module):
        hidden: int
        n_label: int

        def __call__(self, g, x, deterministic=True):
            h = jax.nn.relu(GCNConv(self.hidden)(g, x))
            return GCNConv(self.n_label)(g, h)  # logits (bce loss downstream)

    model = PPIModel(hidden=args.hidden, n_label=n_label)
    g0 = train_graphs[0]
    params = model.init(jax.random.key(0), g0, g0.node_feat)["params"]
    tx = optax.adam(5e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, g, x, y, mask):
        def loss_of(p):
            logits = model.apply({"params": p}, g, x)
            return masked_bce_loss(logits, y, mask)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state2 = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        for g in train_graphs:
            params, opt_state, loss = step(params, opt_state, g, g.node_feat,
                                           g.labels, g.node_mask)
    jax.block_until_ready(loss)
    train_s = time.perf_counter() - t0

    f1s = []
    for g in test_graphs:
        logits = model.apply({"params": params}, g, g.node_feat)
        pred = (np.asarray(logits) > 0).astype(np.float32)
        f1s.append(micro_f1(pred[: g.n_real_node],
                            np.asarray(g.labels)[: g.n_real_node]))
    print({"loss": float(loss), "test_micro_f1": float(np.mean(f1s)),
           "train_s": round(train_s, 2), "epochs": args.epochs})


if __name__ == "__main__":
    main()
