"""Numerical parity of sparse ops vs dense reference math."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dgll_tpu.ops import (
    fused_gcn_layer,
    sddmm_coo,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
    spmm_coo,
    spmm_max_coo,
    spmm_mean_coo,
)


@pytest.fixture
def coo():
    rng = np.random.default_rng(0)
    n, e, d = 50, 400, 16
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    A = np.zeros((n, n), np.float32)
    np.add.at(A, (dst, src), w)  # duplicate edges accumulate
    return src, dst, w, x, A


def test_spmm_matches_dense(coo):
    src, dst, w, x, A = coo
    out = spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), A.shape[0], jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(out), A @ x, rtol=1e-4, atol=1e-4)


def test_spmm_unweighted(coo):
    src, dst, _, x, _ = coo
    n = x.shape[0]
    A = np.zeros((n, n), np.float32)
    np.add.at(A, (dst, src), 1.0)
    out = spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n)
    np.testing.assert_allclose(np.asarray(out), A @ x, rtol=1e-4, atol=1e-4)


def test_spmm_mean_max(coo):
    src, dst, _, x, _ = coo
    n = x.shape[0]
    mean = np.zeros_like(x)
    mx = np.zeros_like(x)
    for i in range(n):
        nb = src[dst == i]
        if len(nb):
            mean[i] = x[nb].mean(0)
            mx[i] = x[nb].max(0)
    got_mean = spmm_mean_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n)
    got_max = spmm_max_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n)
    np.testing.assert_allclose(np.asarray(got_mean), mean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_max), mx, rtol=1e-4, atol=1e-4)


def test_sddmm(coo):
    src, dst, _, x, _ = coo
    y = x + 1.0
    got = sddmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(y), jnp.asarray(x))
    expect = np.sum(y[dst] * x[src], axis=-1)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-4, atol=1e-4)


def test_segment_ops():
    data = jnp.asarray(np.arange(12, dtype=np.float32).reshape(6, 2))
    seg = jnp.asarray([0, 0, 2, 2, 2, 3])
    s = segment_sum(data, seg, 5)
    m = segment_mean(data, seg, 5)
    mx = segment_max(data, seg, 5)
    np.testing.assert_allclose(np.asarray(s)[0], [2, 4])
    np.testing.assert_allclose(np.asarray(m)[2], [6, 7])
    np.testing.assert_allclose(np.asarray(mx)[2], [8, 9])
    # empty segments are zero (not -inf / garbage)
    np.testing.assert_allclose(np.asarray(mx)[1], [0, 0])
    np.testing.assert_allclose(np.asarray(mx)[4], [0, 0])


def test_segment_softmax_normalises():
    rng = np.random.default_rng(1)
    logits = jnp.asarray(rng.normal(size=(20,)).astype(np.float32))
    seg = jnp.asarray(rng.integers(0, 5, 20))
    p = segment_softmax(logits, seg, 6)
    sums = np.zeros(6)
    np.add.at(sums, np.asarray(seg), np.asarray(p))
    nonempty = np.bincount(np.asarray(seg), minlength=6) > 0
    np.testing.assert_allclose(sums[nonempty], 1.0, rtol=1e-5)
    assert np.all(sums[~nonempty] == 0)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("op", ["softmax", "max", "sum"])
def test_segment_ops_multihead_with_empty_segments(op, heads):
    """[E, H] data over 8 segments, of which 1, 4 and 7 are empty: each head
    reduces independently and empty segments come out as 0."""
    rng = np.random.default_rng(heads)
    seg = np.sort(rng.choice([0, 2, 3, 5, 6], 30))
    data = rng.normal(size=(30, heads)).astype(np.float32)
    want = np.zeros((8, heads) if op != "softmax" else (30, heads))
    for s in np.unique(seg):
        rows = data[seg == s]
        if op == "sum":
            want[s] = rows.sum(0)
        elif op == "max":
            want[s] = rows.max(0)
        else:
            ex = np.exp(rows - rows.max(0))
            want[seg == s] = ex / ex.sum(0)
    fn = {"softmax": segment_softmax, "max": segment_max, "sum": segment_sum}[op]
    got = np.asarray(fn(jnp.asarray(data), jnp.asarray(seg), 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if op != "softmax":
        assert not got[[1, 4, 7]].any()


def test_segment_softmax_extreme_logits():
    logits = jnp.asarray([1000.0, 999.0, -1000.0, 5.0])
    seg = jnp.asarray([0, 0, 0, 1])
    p = np.asarray(segment_softmax(logits, seg, 2))
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p[:3].sum(), 1.0, rtol=1e-5)


def test_fused_gcn_layer_forward_and_grad(coo):
    src, dst, w, x, A = coo
    rng = np.random.default_rng(2)
    W = rng.normal(size=(16, 8)).astype(np.float32)

    out = fused_gcn_layer(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(x), jnp.asarray(W),
        A.shape[0],
    )
    expect = np.maximum(A @ (x @ W), 0.0)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-3, atol=1e-4)

    # custom VJP vs autodiff through the reference composition
    def ref_loss(x_, W_):
        h = jnp.asarray(A) @ (x_ @ W_)
        return jnp.sum(jax.nn.relu(h) ** 2)

    def fused_loss(x_, W_):
        o = fused_gcn_layer(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), x_, W_, A.shape[0]
        )
        return jnp.sum(o ** 2)

    gx_r, gw_r = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))
    gx_f, gw_f = jax.grad(fused_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_r), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gw_f), np.asarray(gw_r), rtol=1e-3, atol=1e-3)


def test_spmm_grad_edge_weight(coo):
    src, dst, w, x, A = coo

    def loss(w_):
        return jnp.sum(spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x),
                                A.shape[0], w_) ** 2)

    g = jax.grad(loss)(jnp.asarray(w))
    # analytic gradient: dL/dw_k = 2 * <out[dst_k], x[src_k]>  (per-edge, duplicates split)
    out = A @ x
    expect = 2.0 * np.sum(out[dst] * x[src], axis=-1)
    np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-3, atol=1e-3)


def test_spmm_coo_feature_tiling_matches_untiled(monkeypatch):
    """The >2GB [E, F] message guard (feature-tiled COO path) must be
    numerically identical to the untiled path, for sum (weighted) and max."""
    import dgll_tpu.ops.spmm as spmm_mod

    rng = np.random.default_rng(0)
    n, e, f = 64, 500, 384
    src = jnp.asarray(rng.integers(0, n, e))
    dst = jnp.asarray(rng.integers(0, n, e))
    w = jnp.asarray(rng.random(e).astype(np.float32))
    x = jnp.asarray(rng.standard_normal((n, f)).astype(np.float32))

    base_sum = spmm_mod.spmm_coo(src, dst, x, n, w)
    base_max = spmm_mod.spmm_max_coo(src, dst, x, n)
    base_mean = spmm_mod.spmm_mean_coo(src, dst, x, n)
    monkeypatch.setattr(spmm_mod, "_MSG_TILE_BYTES", 1)  # force tiling
    np.testing.assert_allclose(np.asarray(spmm_mod.spmm_coo(src, dst, x, n, w)),
                               np.asarray(base_sum), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(spmm_mod.spmm_max_coo(src, dst, x, n)),
                               np.asarray(base_max), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(spmm_mod.spmm_mean_coo(src, dst, x, n)),
                               np.asarray(base_mean), rtol=1e-6)
    # grads flow through the tiled path
    g = jax.grad(lambda x_: jnp.sum(spmm_mod.spmm_coo(src, dst, x_, n, w) ** 2))(x)
    assert np.isfinite(np.asarray(g)).all()
