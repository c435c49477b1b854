"""GPU against CPU on small inputs: the aggregation and the attention layer
compiled for the card agree with the same code on the host. Skips without a
GPU; on the card: ``DGLL_TEST_GPU=1 python -m pytest tests -m gpu``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgll_tpu.graph import Graph
from dgll_tpu.nn import GATConv
from dgll_tpu.ops import spmm_coo

pytestmark = pytest.mark.gpu


def _graph(n=2000, e=30000):
    rng = np.random.default_rng(0)
    return Graph.from_edges(rng.integers(0, n, e), rng.integers(0, n, e), n,
                            edge_weight=rng.uniform(0.1, 1, e))


def test_spmm_coo_gpu_matches_cpu(gpu):
    g = _graph()
    x = np.random.default_rng(1).standard_normal((g.n_node, 128)).astype(np.float32)
    f = jax.jit(lambda x, s, d, w: spmm_coo(s, d, x, g.n_node, w))
    args = (x, g.src, g.dst, g.edge_weight)
    got = f(*jax.device_put(args, gpu))
    want = f(*jax.device_put(args, jax.devices("cpu")[0]))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_gat_layer_gpu_matches_cpu(gpu):
    g = _graph()
    x = jnp.asarray(np.random.default_rng(2).standard_normal((g.n_node, 64)),
                    jnp.float32)
    conv = GATConv(8, num_heads=8)
    params = conv.init(jax.random.key(0), g, x)["params"]

    @jax.jit
    def fwd(p, g, x):
        return conv.apply({"params": p}, g, x)

    args = jax.tree.map(np.asarray, (params, g, x))
    with jax.default_matmul_precision("highest"):
        got = fwd(*jax.device_put(args, gpu))
        want = fwd(*jax.device_put(args, jax.devices("cpu")[0]))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
