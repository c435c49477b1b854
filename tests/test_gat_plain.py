"""``GATConv``'s edge-list (COO) attention against a dense masked softmax:
forward for several head counts and widths, with and without attention
dropout, gradients of the projection and both attention vectors, the bf16
output dtype, and destinations with no in-edges."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgll_tpu.graph import Graph
from dgll_tpu.nn import GATConv

N, D_IN = 48, 12


def _graph(isolated=()):
    """Random graph without duplicate edges; ``isolated`` nodes get no in-edges."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, 400)
    dst = rng.integers(0, N, 400)
    keep = ~np.isin(dst, list(isolated))
    key = np.unique(src[keep] * N + dst[keep])
    return Graph.from_edges(key // N, key % N, N)


def _dense_gat(params, g, x, heads, feats, concat=True, slope=0.2):
    """Dense reference: scores on the full N x N grid, softmax over each row's
    in-neighbours only (mask), rows without in-neighbours give 0."""
    w = params["weight"]["kernel"]
    h = (x @ w).reshape(N, heads, feats)
    s_src = jnp.einsum("nhf,hf->nh", h, params["attn_src"])
    s_dst = jnp.einsum("nhf,hf->nh", h, params["attn_dst"])
    mask = np.zeros((N, N), bool)
    mask[np.asarray(g.dst), np.asarray(g.src)] = True            # [dst, src]
    e = jax.nn.leaky_relu(s_dst[:, None, :] + s_src[None, :, :], slope)  # [i, j, h]
    e = jnp.where(mask[..., None], e, -jnp.inf)
    m = jnp.max(e, axis=1, keepdims=True)
    ex = jnp.where(mask[..., None], jnp.exp(e - jnp.where(jnp.isfinite(m), m, 0.0)), 0.0)
    alpha = ex / jnp.maximum(ex.sum(axis=1, keepdims=True), 1e-16)
    out = jnp.einsum("ijh,jhf->ihf", alpha, h)
    return out.reshape(N, heads * feats) if concat else out.mean(axis=1)


def _setup(heads, feats, **kw):
    g = _graph()
    x = jax.random.normal(jax.random.key(1), (N, D_IN))
    conv = GATConv(feats, num_heads=heads, **kw)
    params = conv.init(jax.random.key(2), g, x)["params"]
    return g, x, conv, params


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("feats", [8, 16, 64])
@pytest.mark.parametrize("heads", [1, 4, 8])
def test_gat_coo_matches_dense(heads, feats, dropout):
    g, x, conv, params = _setup(heads, feats, attn_dropout=0.5 if dropout else 0.0)
    ref = np.asarray(_dense_gat(params, g, x, heads, feats))
    out = np.asarray(conv.apply({"params": params}, g, x))  # deterministic
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    if not dropout:
        return
    # attention dropout: reproducible per key, different across keys, and
    # unbiased (inverted scaling) — the mean over many keys approaches ref
    def drop(k):
        return conv.apply({"params": params}, g, x, deterministic=False,
                          rngs={"dropout": k})

    keys = jax.random.split(jax.random.key(3), 256)
    outs = np.asarray(jax.vmap(drop)(keys))
    np.testing.assert_array_equal(outs[0], np.asarray(drop(keys[0])))
    assert not np.allclose(outs[0], outs[1])
    # every element's mean within 6 standard errors of the reference
    se = outs.std(0) / np.sqrt(len(keys))
    assert (np.abs(outs.mean(0) - ref) <= 6 * se + 1e-5 * np.abs(ref).max()).all()


@pytest.mark.parametrize("feats", [8, 16, 64])
@pytest.mark.parametrize("heads", [1, 4, 8])
def test_gat_coo_gradients_match_dense(heads, feats):
    g, x, conv, params = _setup(heads, feats)
    ct = jax.random.normal(jax.random.key(4), (N, heads * feats))

    def loss_coo(p):
        return jnp.sum(conv.apply({"params": p}, g, x) * ct)

    def loss_dense(p):
        return jnp.sum(_dense_gat(p, g, x, heads, feats) * ct)

    got, want = jax.grad(loss_coo)(params), jax.grad(loss_dense)(params)
    for name in ("attn_src", "attn_dst"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5 * np.abs(want[name]).max())
    np.testing.assert_allclose(got["weight"]["kernel"], want["weight"]["kernel"],
                               rtol=1e-4,
                               atol=1e-5 * np.abs(want["weight"]["kernel"]).max())


@pytest.mark.parametrize("heads", [1, 8])
def test_gat_bf16_output_dtype(heads):
    g, x, _, params = _setup(heads, 8)
    conv16 = GATConv(8, num_heads=heads, dtype=jnp.bfloat16)
    out16 = conv16.apply({"params": params}, g, x)
    assert out16.dtype == jnp.bfloat16
    ref = np.asarray(_dense_gat(params, g, x, heads, 8))
    assert np.abs(np.asarray(out16, np.float32) - ref).max() < 3e-2 * np.abs(ref).max()


@pytest.mark.parametrize("concat", [True, False])
def test_gat_zero_in_degree_rows_are_zero(concat):
    isolated = (0, 5, 17)
    g = _graph(isolated)
    x = jax.random.normal(jax.random.key(1), (N, D_IN))
    conv = GATConv(8, num_heads=4, concat_heads=concat)
    params = conv.init(jax.random.key(2), g, x)["params"]
    out = np.asarray(conv.apply({"params": params}, g, x))
    assert np.isfinite(out).all()
    assert not out[list(isolated)].any()
    np.testing.assert_allclose(out, np.asarray(_dense_gat(params, g, x, 4, 8, concat)),
                               rtol=1e-5, atol=1e-6)
    grads = jax.grad(lambda p: conv.apply({"params": p}, g, x).sum())(params)
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree.leaves(grads))
