"""``spmm_coo`` (gather + segment_sum, the aggregation every full-graph layer
runs) against ``scipy.sparse`` in float64: forward and the gradients with
respect to the features and the edge weights, over the graph shapes that stress
a scatter — power-law and clustered degree, a hub with over 10k in-edges, empty
rows, padded graphs — and the feature widths and dtypes the layers use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from dgll_tpu.graph import Graph, pad_graph
from dgll_tpu.ops import spmm_coo

N = 600


def _power_law(rng):
    w = (np.arange(N) + 1.0) ** -1.0
    dst = rng.choice(N, 6000, p=w / w.sum())
    return rng.integers(0, N, 6000), dst


def _clustered(rng):
    dst = rng.integers(0, N, 6000)
    src = np.where(rng.random(6000) < 0.9,
                   (dst // 64) * 64 + rng.integers(0, 64, 6000),
                   rng.integers(0, N, 6000)) % N
    return src, dst


def _hub(rng):
    # node 7 receives 12k messages; the rest are sparse
    src = np.concatenate([rng.integers(0, N, 12_000), rng.integers(0, N, 1500)])
    dst = np.concatenate([np.full(12_000, 7), rng.integers(0, N, 1500)])
    return src, dst


def _empty_rows(rng):
    # only even nodes receive messages; odd rows must come out exactly zero
    dst = 2 * rng.integers(0, N // 2, 3000)
    return rng.integers(0, N, 3000), dst


GRAPHS = {"power_law": _power_law, "clustered": _clustered, "hub": _hub,
          "empty_rows": _empty_rows, "padded": _clustered}


def _graph(kind: str):
    rng = np.random.default_rng(sorted(GRAPHS).index(kind))
    src, dst = GRAPHS[kind](rng)
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    g = Graph.from_edges(src, dst, N, edge_weight=w)
    if kind == "padded":
        g = pad_graph(g, node_multiple=64, edge_multiple=1024)
        assert g.n_edge > g.n_real_edge and g.n_node > g.n_real_node
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [8, 100, 128, 256])
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_spmm_coo_matches_scipy(kind, width, dtype):
    g = _graph(kind)
    n, src, dst = g.n_node, np.asarray(g.src), np.asarray(g.dst)
    w = np.asarray(g.edge_weight)
    rng = np.random.default_rng(width)
    x = rng.standard_normal((n, width)).astype(np.float32)
    ct = rng.standard_normal((n, width)).astype(np.float32)
    dt = jnp.dtype(dtype)
    # the op sees its inputs rounded to dtype; so does the reference
    x_in = np.asarray(jnp.asarray(x, dt), np.float64)
    w_in = np.asarray(jnp.asarray(w, dt), np.float64)
    a = sp.csr_matrix((w_in, (dst, src)), shape=(n, n))

    def f(x, w):
        return spmm_coo(g.src, g.dst, x, n, w)

    out, vjp = jax.vjp(f, jnp.asarray(x, dt), jnp.asarray(w, dt))
    gx, gw = vjp(jnp.asarray(ct, dt))
    assert out.dtype == dt and gx.dtype == dt

    ref = a @ x_in
    ct_in = np.asarray(jnp.asarray(ct, dt), np.float64)
    ref_gx = a.T @ ct_in
    ref_gw = np.einsum("ef,ef->e", ct_in[dst], x_in[src])

    # f32: only the summation order differs. bf16: the sums run in f32 and
    # the result is rounded once to bf16's 8-bit mantissa (2^-9 relative).
    # Errors are relative to the array's scale.
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    for name, got, want in (("out", out, ref), ("grad_x", gx, ref_gx),
                            ("grad_w", gw, ref_gw)):
        err = np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()
        assert err <= tol, (name, err)
    if kind == "empty_rows":
        assert not np.asarray(out, np.float64)[1::2].any()
    if kind == "padded":
        assert not np.asarray(out, np.float64)[g.n_real_node:].any()
