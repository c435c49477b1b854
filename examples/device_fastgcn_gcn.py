"""Device-resident FastGCN training: the reference's fastest algorithm
(``MQFastGCN.py:60-88``, the 6.12 ms/batch source) running entirely inside the
jitted scanned epoch — alias-table importance draws, WeightedBlock dense
aggregation, compiled eval sweep. Its time at products scale on the H100 is not
measured yet.

Run: python examples/device_fastgcn_gcn.py
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp
import optax

from dgll_tpu.data import synthetic_classification_graph
from dgll_tpu.nn import GCN
from dgll_tpu.sampling import build_device_lap
from dgll_tpu.train import DeviceEpochRunner

g = synthetic_classification_graph(n_node=30_000, avg_degree=12, n_class=16,
                                   feat_dim=64, power_law=1.0, homophily=0.8,
                                   seed=0)
lap = build_device_lap(g, k=32)           # ELL-packed normalized Laplacian in HBM
model = GCN(hidden=64, n_class=16, dropout=0.0)
runner = DeviceEpochRunner(model, optax.adam(1e-3), lap,
                           fanouts=[1024, 512],  # per-layer sample sizes
                           batch_size=256, train_nodes=g.get_train_nodes(),
                           seed=0, sampler="fastgcn")
feats, labels = jnp.asarray(g.node_feat), jnp.asarray(g.labels)
state = runner.init_state(feats)
for ep in range(10):
    state, loss = runner.run_epoch(state, feats, labels)   # ONE dispatch
    print(f"epoch {ep}: loss {float(loss):.3f}")
val = runner.evaluate_nodes(state, feats, np.asarray(g.labels),
                            g.get_validation_nodes())      # compiled sweep
print(f"val acc {val:.3f}")
