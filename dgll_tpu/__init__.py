"""dgll_tpu — a graph neural network framework on JAX.

Built from scratch on JAX/XLA with the capability surface of dke-lab/dgll
(see SURVEY.md): device-resident static-shape graphs, sparse message-passing ops on
XLA gather/scatter, the GCN/GAT/GraphSAGE/GIN model family, neighbor + layer-wise importance
samplers with a prefetch-overlapped minibatch pipeline, an HBM hot-node feature cache,
random-walk graph embeddings, and mesh-sharded multi-chip training.
"""
from dgll_tpu.graph import Graph, pad_graph

__version__ = "0.1.0"

__all__ = ["Graph", "pad_graph", "__version__"]
