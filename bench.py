"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric: **end-to-end training batch time, sampling included**, for
minibatch GraphSAGE at ogbn-products scale (2-layer, fanouts [15,10], batch
1024, feat 100 — the reference's flagship MQ-GNN workload). The pipeline is the
device-resident one (``dgll_tpu/train/device_pipeline.py``): the graph CSR
lives in device memory, fanout sampling is a jitted gather (block-window mode),
and a whole epoch compiles to a single ``lax.scan`` dispatch. ``vs_baseline``
compares against DGLL's best published per-batch time on ogbn-products —
6.12 ms on 1 GPU, *including* its host sampling (BASELINE.md: README.md:45) —
so this is the like-for-like number; >1.0 means faster per batch.

Every timed window ends in ``block_until_ready``. The run refuses a host with
no GPU: a CPU time is not a device measurement.

Scale knobs via env: BENCH_NODES, BENCH_DEG, BENCH_BATCH, BENCH_WINDOW=0
(exact per-slot sampling instead of block-window), BENCH_STEPONLY=0 (skip the
device-step-only secondary), BENCH_FULLGRAPH=0 (skip the full-graph GCN
secondary).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def power_law_graph(n_node: int, avg_deg: int, alpha: float = 0.9, seed: int = 0):
    """Fast Zipf-ish COO via inverse-CDF (rng.choice with p is too slow at this scale)."""
    rng = np.random.default_rng(seed)
    n_edge = n_node * avg_deg
    w = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
    src = rng.integers(0, n_node, n_edge)
    return src, dst


def power_law_csr(n_node: int, avg_deg: int, seed: int = 0):
    """In-edge CSR ``(indptr, src)`` of :func:`power_law_graph`."""
    from dgll_tpu import native

    src, dst = power_law_graph(n_node, avg_deg, seed=seed)
    fused = native.build_csr_apply(dst, src, None, n_node)
    if fused is not None:
        indptr, src_s, _, _ = fused
        return indptr, src_s
    indptr, order = native.build_csr(dst, n_node)
    return indptr, src[order].astype(np.int32)


def main() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from benchmarks.peaks import card_name_and_power_limit
    from dgll_tpu.nn import GraphSAGE
    from dgll_tpu.sampling import DeviceCSR
    from dgll_tpu.train import DeviceEpochRunner
    from dgll_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    card = card_name_and_power_limit()
    _log(f"device {dev.device_kind} x{len(jax.devices())} ({card})")

    n_node = int(os.environ.get("BENCH_NODES", 2_400_000))
    avg_deg = int(os.environ.get("BENCH_DEG", 25))
    batch = int(os.environ.get("BENCH_BATCH", 1024))
    window = os.environ.get("BENCH_WINDOW", "1") == "1"
    feat_dim, n_class, hidden = 100, 48, 256
    fanouts = [15, 10]
    train_frac = 0.08  # products-like split

    t0 = time.perf_counter()
    indptr, src_s = power_law_csr(n_node, avg_deg)
    _log(f"csr built {time.perf_counter()-t0:.1f}s ({n_node} nodes, {len(src_s)} edges)")

    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.standard_normal((n_node, feat_dim), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, n_class, n_node).astype(np.int32))
    jax.block_until_ready(feats)
    train_nodes = rng.choice(n_node, int(train_frac * n_node), replace=False)
    _log(f"features on device {time.perf_counter()-t0:.1f}s")

    csr = DeviceCSR.from_host_arrays(indptr, src_s)
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)
    runner = DeviceEpochRunner(model, optax.adam(1e-3), csr, fanouts, batch,
                               train_nodes, seed=0, window=window)
    state = runner.init_state(feats)
    state, loss = jax.block_until_ready(runner.run_epoch(state, feats, labels))
    _log(f"device pipeline compiled {time.perf_counter()-t0:.1f}s "
         f"(warmup loss {float(loss):.4f})")

    batch_s = None
    for _ in range(2):
        t1 = time.perf_counter()
        state, loss = jax.block_until_ready(runner.run_epoch(state, feats, labels))
        batch_s = (time.perf_counter() - t1) / runner.n_batches
        _log(f"epoch {batch_s*runner.n_batches:.2f}s "
             f"({batch_s*1e3:.3f} ms/batch) loss={float(loss):.4f}")
    batch_ms = batch_s * 1e3

    # edges aggregated per batch across both layers
    edges_per_batch = batch * fanouts[-1] + batch * (1 + fanouts[-1]) * fanouts[0]

    detail = {
        "includes_sampling": True,
        "sampling": "device block-window" if window else "device per-slot",
        "n_batches_per_epoch": runner.n_batches,
        "edges_per_s": int(edges_per_batch / batch_s),
        "n_node": n_node,
        "avg_deg": avg_deg,
        "batch": batch,
        "fanouts": fanouts,
        "feat_dim": feat_dim,
        "hidden": hidden,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }

    # ---- secondary: device-step-only time (host-presampled blocks), the r2
    # headline — kept for continuity so step vs step+sampling is visible
    if os.environ.get("BENCH_STEPONLY", "1") != "0":
        detail["step_only_ms"] = _step_only_bench(
            jax, jnp, indptr, src_s, n_node, feats, labels, batch, fanouts,
            hidden, n_class)
        _log(f"step-only: {detail['step_only_ms']} ms")

    # ---- secondary: full-graph GCN train step (the reference's fused CUDA
    # kernel workload, FusedKernel/train_gcn.py:95-110), with its share of the
    # aggregation bytes' device-memory bound.
    if os.environ.get("BENCH_FULLGRAPH", "1") != "0":
        fullgraph = _fullgraph_bench(jax, jnp, dev.device_kind)
        detail["fullgraph_gcn"] = fullgraph
        _log(f"fullgraph bench: {fullgraph}")

    baseline_ms = 6.12  # DGLL MQ-FastGCN+f+d ogbn-products batch time, 1 GPU
    print(json.dumps({
        "metric": "sage_batch_time_incl_sampling",
        "value": round(batch_ms, 4),
        "unit": "ms",
        "vs_baseline": round(baseline_ms / batch_ms, 3),
        "detail": detail,
    }))


def _step_only_bench(jax, jnp, indptr, src_s, n_node, feats, labels, batch,
                     fanouts, hidden, n_class):
    import optax

    from dgll_tpu.nn import GraphSAGE
    from dgll_tpu.sampling import HostGraph, NeighborSampler
    from dgll_tpu.train import MiniBatchTrainer

    hg = HostGraph(indptr, src_s, n_node)
    rng = np.random.default_rng(1)
    sampler = NeighborSampler(fanouts, seed=0)
    pool = []
    for _ in range(8):
        seeds = rng.integers(0, n_node, batch)
        _, _, blocks = sampler.sample(hg, seeds, pad_to=batch)
        x = jnp.take(feats, jnp.asarray(blocks[0].src_ids), axis=0)
        y = jnp.take(labels, jnp.asarray(blocks[-1].dst_ids), axis=0)
        pool.append((tuple(jax.device_put(b) for b in blocks), x, y,
                     jnp.asarray(blocks[-1].dst_mask)))
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)
    tr = MiniBatchTrainer(model, optax.adam(1e-3))
    state = tr.init_state(list(pool[0][0]), pool[0][1])
    key = jax.random.key(0)
    b, x, y, m = pool[0]
    state, loss = jax.block_until_ready(tr.step(state, b, x, y, m, key))

    def run_chain(k: int) -> float:
        nonlocal state
        t1 = time.perf_counter()
        for i in range(k):
            b, x, y, m = pool[i % len(pool)]
            state, loss = tr.step(state, b, x, y, m, key)
        jax.block_until_ready((state, loss))
        return time.perf_counter() - t1

    run_chain(2)
    t_small = run_chain(10)
    t_large = run_chain(30)
    return round(max((t_large - t_small) / 20, 1e-9) * 1e3, 4)


def _fullgraph_bench(jax, jnp, device_kind: str) -> dict:
    """Full-graph 2-layer GCN train step on the plain XLA aggregation."""
    import optax

    from benchmarks.peaks import aggregation_bytes, bound_share
    from dgll_tpu.data import gcn_normalize
    from dgll_tpu.nn import GCN
    from dgll_tpu.train.trainer import create_train_state, make_full_batch_step

    n_node = int(os.environ.get("BENCH_FG_NODES", 200_000))
    avg_deg = int(os.environ.get("BENCH_FG_DEG", 16))
    # bfloat16 runs the layer compute in bf16 (half the gather bytes);
    # params/optimizer stay f32 (standard mixed precision)
    dtype = jnp.dtype(os.environ.get("BENCH_FG_DTYPE", "float32"))
    feat_dim, hidden, n_class = 128, 128, 128
    g = clustered_graph(n_node, avg_deg, feat_dim, n_class)
    g = gcn_normalize(g).to_device()

    model = GCN(hidden=hidden, n_class=n_class, dropout=0.0,
                dtype=None if dtype == jnp.float32 else dtype)
    state = create_train_state(model, jax.random.key(0), optax.adam(1e-3), g,
                               g.node_feat)
    step = make_full_batch_step()
    key = jax.random.key(1)

    def run_chain(k: int) -> float:
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(k):
            state, loss = step(state, g, g.node_feat, g.labels, g.train_mask, key)
        jax.block_until_ready((state, loss))
        return time.perf_counter() - t0

    run_chain(2)
    t_small = run_chain(3)
    t_large = run_chain(9)
    dt = max((t_large - t_small) / 6, 1e-9)
    n_edge = g.n_real_edge
    # fwd: 2 aggregations; bwd: 2 transposed aggregations (every width is 128)
    bytes_moved = 4 * aggregation_bytes(n_edge, n_node, hidden, dtype.itemsize)
    return {
        "dtype": str(dtype),
        "step_ms": round(dt * 1e3, 4),
        "edges_per_s_per_layerpass": int(4 * n_edge / dt),
        "n_node": n_node,
        "n_edge": int(n_edge),
        "aggregation_bound_share": round(bound_share(bytes_moved, dt, device_kind), 4),
    }


def clustered_graph(n_node: int, avg_deg: int, feat_dim: int, n_class: int,
                    seed: int = 1, cluster: int = 2048, local: float = 0.9):
    """Clustered graph with random features/labels, all nodes in train: 90% of
    each node's in-edges come from its own ``cluster``-node block, the rest
    from anywhere — the community structure of products/reddit-like graphs."""
    from dgll_tpu.graph import Graph

    rng = np.random.default_rng(seed)
    n_edge0 = n_node * avg_deg
    dstc = rng.integers(0, n_node, n_edge0)
    loc = rng.random(n_edge0) < local
    srcc = np.where(loc, (dstc // cluster) * cluster + rng.integers(0, cluster, n_edge0),
                    rng.integers(0, n_node, n_edge0)) % n_node
    return Graph.from_edges(
        srcc, dstc, n_node,
        node_feat=rng.standard_normal((n_node, feat_dim), dtype=np.float32),
        labels=rng.integers(0, n_class, n_node).astype(np.int32),
        train_mask=np.ones(n_node, bool),
        add_self_loops=True,
    )


if __name__ == "__main__":
    main()
