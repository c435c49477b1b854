"""Products-scale end-to-end training epoch, sampling INCLUDED.

Measures the number that matters (SURVEY.md §6 north star): wall-clock per
batch for a full training epoch — sampling + feature gather + fwd/bwd +
optimizer — against DGLL's best published ogbn-products batch time
(6.12 ms, /root/reference/README.md:45, MQ-FastGCN+f+d on 1 GPU).

Two pipelines:

* **device** (headline): graph CSR + features resident in HBM; sampling is a
  jitted gather and the whole epoch is ONE ``lax.scan`` dispatch
  (``dgll_tpu/train/device_pipeline.py``). Optional bf16 variant.
* **host** (``EB_HOST=1``): the prefetch-threaded DataLoader samples on the
  host (C++ sampler) while the device trains — the fallback for graphs larger
  than HBM, and the closest analog of the reference's CPU-sampling pipeline.

Run on the GPU: ``python benchmarks/epoch_bench.py``; env: EB_NODES (default
2.4M), EB_DEG (default 25), EB_HOST, EB_BF16 (default 1), EB_OUT.
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

    from dgll_tpu.nn import GraphSAGE
    from dgll_tpu.sampling import DeviceCSR, HostGraph, NeighborSampler
    from dgll_tpu.train import DeviceEpochRunner, MiniBatchTrainer

    n_node = int(os.environ.get("EB_NODES", 2_400_000))
    avg_deg = int(os.environ.get("EB_DEG", 25))
    out_path = os.environ.get("EB_OUT", "")
    run_host = os.environ.get("EB_HOST", "0") == "1"
    run_bf16 = os.environ.get("EB_BF16", "1") == "1"
    batch, fanouts = 1024, [15, 10]
    feat_dim, hidden, n_class = 100, 256, 48
    train_frac = 0.08  # ogbn-products-like train split (196k/2.4M)

    rng = np.random.default_rng(0)
    n_edge = n_node * avg_deg
    t0 = time.perf_counter()
    w = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-0.9)
    cdf = np.cumsum(w); cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
    src = rng.integers(0, n_node, n_edge)
    print(f"[epoch] gen {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

    from dgll_tpu import native

    indptr, src_s, _, _ = native.build_csr_apply(dst, src, None, n_node)
    print(f"[epoch] csr {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

    feats = jnp.asarray(rng.standard_normal((n_node, feat_dim), dtype=np.float32))
    labels = jnp.asarray(rng.integers(0, n_class, n_node).astype(np.int32))
    jax.block_until_ready(feats)
    train_nodes = rng.choice(n_node, int(train_frac * n_node), replace=False)
    print(f"[epoch] features on device {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)

    detail = {
        "device": str(jax.devices()[0]),
        "n_node": n_node, "n_edge": n_edge,
        "train_nodes": len(train_nodes),
        "batch": batch, "fanouts": fanouts,
    }

    def timed_epochs(fn, reps=2):
        """fn() must return the epoch's loss; the timed window ends in its
        value read, which waits for the epoch. Returns (last rep seconds, last
        loss)."""
        dt = loss = None
        for _ in range(reps):
            t = time.perf_counter()
            loss = float(fn())
            dt = time.perf_counter() - t
            print(f"[epoch] measured {dt:.2f}s loss={loss:.4f}",
                  file=sys.stderr, flush=True)
        return dt, loss

    run_device = os.environ.get("EB_DEVICE", "1") == "1"
    n_batches = max(1, -(-len(train_nodes) // batch))
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)

    # ---------------- device pipeline (headline): epoch = ONE dispatch
    if not run_device:
        run_bf16 = False
    csr = DeviceCSR.from_host_arrays(indptr, src_s) if run_device else None
    runner = DeviceEpochRunner(model, optax.adam(1e-3), csr, fanouts, batch,
                               train_nodes, seed=0) if run_device else None
    dev_s = 0.0
    if run_device:
        state = runner.init_state(feats)
        state, loss = runner.run_epoch(state, feats, labels)
        print(f"[epoch] device pipeline compiled {time.perf_counter()-t0:.1f}s "
              f"(warmup loss {float(loss):.4f})", file=sys.stderr, flush=True)

        def dev_epoch():
            nonlocal state
            state, loss = runner.run_epoch(state, feats, labels)
            return loss

        dev_s, dev_loss = timed_epochs(dev_epoch)
        n_batches = runner.n_batches
        dev_ms = dev_s / n_batches * 1e3
        detail["device_pipeline"] = {
            "epoch_s": round(dev_s, 3), "n_batches": n_batches,
            "batch_ms_incl_sampling": round(dev_ms, 3),
            "loss": round(dev_loss, 4),
            "vs_dgll_products_batch": round(6.12 / dev_ms, 2),
        }

    # ---------------- block-window sampling (one CSR window row per node —
    # XLA's gather costs ~4 ns/ROW, so this cuts sampling gathers by the fanout)
    if run_device and os.environ.get("EB_WINDOW", "1") == "1":
        runner_w = DeviceEpochRunner(model, optax.adam(1e-3), csr, fanouts,
                                     batch, train_nodes, seed=0, window=True)
        state_w = runner_w.init_state(feats)
        state_w, lw = runner_w.run_epoch(state_w, feats, labels)
        float(lw)

        def devw_epoch():
            nonlocal state_w
            state_w, loss = runner_w.run_epoch(state_w, feats, labels)
            return loss

        w_s, w_loss = timed_epochs(devw_epoch)
        w_ms = w_s / n_batches * 1e3
        detail["device_pipeline_window"] = {
            "epoch_s": round(w_s, 3),
            "batch_ms_incl_sampling": round(w_ms, 3),
            "loss": round(w_loss, 4),
            "vs_dgll_products_batch": round(6.12 / w_ms, 2),
        }

    # ---------------- window + bf16 combined (the fastest configuration)
    if run_device and os.environ.get("EB_WINDOW", "1") == "1" and run_bf16:
        model16w = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0,
                             dtype=jnp.bfloat16)
        runner_wb = DeviceEpochRunner(model16w, optax.adam(1e-3), csr, fanouts,
                                      batch, train_nodes, seed=0, window=True,
                                      feat_dtype=jnp.bfloat16)
        state_wb = runner_wb.init_state(feats)
        state_wb, lwb = runner_wb.run_epoch(state_wb, feats, labels)
        float(lwb)

        def devwb_epoch():
            nonlocal state_wb
            state_wb, loss = runner_wb.run_epoch(state_wb, feats, labels)
            return loss

        wb_s, wb_loss = timed_epochs(devwb_epoch)
        wb_ms = wb_s / n_batches * 1e3
        detail["device_pipeline_window_bf16"] = {
            "epoch_s": round(wb_s, 3),
            "batch_ms_incl_sampling": round(wb_ms, 3),
            "loss": round(wb_loss, 4),
            "vs_dgll_products_batch": round(6.12 / wb_ms, 2),
        }

    # ---------------- bf16 device pipeline
    if run_bf16:
        model16 = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0,
                            dtype=jnp.bfloat16)
        runner16 = DeviceEpochRunner(model16, optax.adam(1e-3), csr, fanouts,
                                     batch, train_nodes, seed=0,
                                     feat_dtype=jnp.bfloat16)
        state16 = runner16.init_state(feats)
        state16, l16 = runner16.run_epoch(state16, feats, labels)
        float(l16)

        def dev16_epoch():
            nonlocal state16
            state16, loss = runner16.run_epoch(state16, feats, labels)
            return loss

        b16_s, b16_loss = timed_epochs(dev16_epoch)
        b16_ms = b16_s / n_batches * 1e3
        detail["device_pipeline_bf16"] = {
            "epoch_s": round(b16_s, 3),
            "batch_ms_incl_sampling": round(b16_ms, 3),
            "loss": round(b16_loss, 4),
            "vs_dgll_products_batch": round(6.12 / b16_ms, 2),
        }

    # ---------------- device-resident LAYER-WISE sampling (FastGCN in-jit):
    # the reference's fastest algorithm (MQFastGCN.py:60-88, the 6.12 ms/batch
    # source) running on the framework's fastest path (scanned epoch)
    if run_device and os.environ.get("EB_LAYERWISE", "1") == "1":
        from dgll_tpu.graph import Graph
        from dgll_tpu.sampling import build_device_lap

        t1 = time.perf_counter()
        # Graph view over the existing CSR (no re-sort; dst expanded from indptr)
        gg = Graph(indptr=indptr.astype(np.int32), src=src_s.astype(np.int32),
                   dst=np.repeat(np.arange(n_node, dtype=np.int32),
                                 np.diff(indptr).astype(np.int64)),
                   n_node=n_node, n_edge=len(src_s),
                   n_real_node=n_node, n_real_edge=len(src_s))
        lap = build_device_lap(gg, k=32)
        print(f"[epoch] device lap built {time.perf_counter()-t1:.1f}s",
              file=sys.stderr, flush=True)
        sizes = [2048, 1024]
        from dgll_tpu.nn import GCN as _GCN
        model_lw = _GCN(hidden=hidden, n_class=n_class, dropout=0.0)
        runner_lw = DeviceEpochRunner(model_lw, optax.adam(1e-3), lap, sizes,
                                      batch, train_nodes, seed=0,
                                      sampler="fastgcn")
        state_lw = runner_lw.init_state(feats)
        state_lw, llw = runner_lw.run_epoch(state_lw, feats, labels)
        float(llw)

        def devlw_epoch():
            nonlocal state_lw
            state_lw, loss = runner_lw.run_epoch(state_lw, feats, labels)
            return loss

        lw_s, lw_loss = timed_epochs(devlw_epoch)
        lw_ms = lw_s / runner_lw.n_batches * 1e3
        detail["device_pipeline_fastgcn"] = {
            "epoch_s": round(lw_s, 3), "layer_sizes": sizes, "ell_k": 32,
            "batch_ms_incl_sampling": round(lw_ms, 3),
            # r5: defensive-IS weighting (prev columns exact) — the loss is now
            # on the same scale as the neighbor-sampler rows (the r4 18615 was
            # the naive everything-rescaled estimator amplifying exact edges)
            "loss": round(lw_loss, 4),
            "vs_dgll_products_batch": round(6.12 / lw_ms, 2),
        }
        print(f"[epoch] fastgcn {lw_ms:.2f} ms/batch", file=sys.stderr, flush=True)

        # -------- LADIES at products scale (VERDICT r4 missing #2): the
        # layer-DEPENDENT sampler in-jit. Its [s, n_prev*K] inverse-CDF compare
        # grows with the frontier, so layer sizes are the largest that keep the
        # scan's peak inside HBM at this batch (documented O(n_prev^2 K)).
        if os.environ.get("EB_LADIES", "1") == "1":
            sizes_l = [int(x) for x in os.environ.get(
                "EB_LADIES_SIZES", "2048,1024").split(",")]
            runner_ld = DeviceEpochRunner(model_lw, optax.adam(1e-3), lap,
                                          sizes_l, batch, train_nodes, seed=0,
                                          sampler="ladies")
            state_ld = runner_ld.init_state(feats)
            state_ld, lld = runner_ld.run_epoch(state_ld, feats, labels)
            float(lld)

            def devld_epoch():
                nonlocal state_ld
                state_ld, loss = runner_ld.run_epoch(state_ld, feats, labels)
                return loss

            ld_s, ld_loss = timed_epochs(devld_epoch)
            ld_ms = ld_s / runner_ld.n_batches * 1e3
            detail["device_pipeline_ladies"] = {
                "epoch_s": round(ld_s, 3), "layer_sizes": sizes_l, "ell_k": 32,
                "batch_ms_incl_sampling": round(ld_ms, 3),
                "loss": round(ld_loss, 4),
                # like-for-like: DGLL's LADIES Reddit number is 4-GPU (2.44 ms,
                # README.md:49); its 1-GPU products-class best is the 6.12 ms
                "vs_dgll_products_batch": round(6.12 / ld_ms, 2),
            }
            print(f"[epoch] ladies {ld_ms:.2f} ms/batch", file=sys.stderr,
                  flush=True)

    # ---------------- GAT through the flagship device pipeline (VERDICT r4
    # missing #4): multi-head attention over fanout-dense sampled blocks,
    # whole epoch still ONE scanned dispatch
    if run_device and os.environ.get("EB_GAT", "1") == "1":
        from dgll_tpu.nn import GAT as _GAT

        model_gat = _GAT(hidden=32, n_class=n_class, num_heads=8, dropout=0.0)
        runner_g = DeviceEpochRunner(model_gat, optax.adam(1e-3), csr, fanouts,
                                     batch, train_nodes, seed=0, window=True)
        state_g = runner_g.init_state(feats)
        state_g, lg = runner_g.run_epoch(state_g, feats, labels)
        float(lg)

        def devg_epoch():
            nonlocal state_g
            state_g, loss = runner_g.run_epoch(state_g, feats, labels)
            return loss

        g_s, g_loss = timed_epochs(devg_epoch)
        g_ms = g_s / runner_g.n_batches * 1e3
        detail["device_pipeline_gat"] = {
            "epoch_s": round(g_s, 3), "heads": 8, "head_dim": 32,
            "batch_ms_incl_sampling": round(g_ms, 3),
            "loss": round(g_loss, 4),
            "vs_dgll_products_batch": round(6.12 / g_ms, 2),
        }
        print(f"[epoch] gat {g_ms:.2f} ms/batch", file=sys.stderr, flush=True)

    # ---------------- compiled evaluation sweep (one dispatch per val set) vs
    # the host-loader sweep it replaces (VERDICT r3 #3 evidence)
    if run_device and os.environ.get("EB_EVAL", "1") == "1":
        val_nodes = rng.choice(n_node, min(50_000, n_node // 2), replace=False)
        tval0 = time.perf_counter()
        _ = runner.evaluate_nodes(state, feats, np.asarray(labels), val_nodes)
        t_compile = time.perf_counter() - tval0
        tval = time.perf_counter()
        acc = runner.evaluate_nodes(state, feats, np.asarray(labels), val_nodes)
        t_dev_eval = time.perf_counter() - tval

        from dgll_tpu.dataloader import DataLoader

        hg_e = HostGraph(indptr, src_s, n_node)
        ev = MiniBatchTrainer(model, optax.adam(1e-3))
        val_loader = DataLoader(hg_e, val_nodes, NeighborSampler(fanouts, seed=1),
                                batch, shuffle=False, seed=1)
        _ = ev.evaluate_nodes(state, val_loader, feats, labels)  # warm/compile
        tval = time.perf_counter()
        val_loader = DataLoader(hg_e, val_nodes, NeighborSampler(fanouts, seed=1),
                                batch, shuffle=False, seed=1)
        _ = ev.evaluate_nodes(state, val_loader, feats, labels)
        t_host_eval = time.perf_counter() - tval
        nb_eval = -(-len(val_nodes) // batch)
        detail["eval_sweep_50k"] = {
            "compiled_sweep_s": round(t_dev_eval, 3),
            "compiled_ms_per_batch": round(t_dev_eval / nb_eval * 1e3, 3),
            "host_loader_sweep_s": round(t_host_eval, 3),
            "host_ms_per_batch": round(t_host_eval / nb_eval * 1e3, 3),
            "speedup": round(t_host_eval / max(t_dev_eval, 1e-9), 2),
        }
        print(f"[epoch] eval sweep dev {t_dev_eval:.2f}s vs host "
              f"{t_host_eval:.2f}s", file=sys.stderr, flush=True)

    # ---------------- host pipeline (fallback for >HBM graphs): PACKED form —
    # the host ships only (ids, mask) per batch; blocks rebuilt + features
    # gathered inside the jitted step (2 H2D transfers/batch)
    if run_host:
        hg = HostGraph(indptr, src_s, n_node)
        sampler = NeighborSampler(fanouts, seed=0)
        tr = MiniBatchTrainer(model, optax.adam(1e-3))
        dev = jax.devices()[0]
        from dgll_tpu.dataloader import DataLoader

        loader = DataLoader(hg, train_nodes, sampler, batch, prefetch=4, seed=0,
                            device=dev, n_producers=2, packed=True)
        _, _, b0 = sampler.sample(hg, train_nodes[:batch], pad_to=batch)
        x0 = jnp.take(feats, jnp.asarray(b0[0].src_ids), axis=0)
        hstate = tr.init_state(b0, x0)
        hstate, _, _ = tr.run_epoch_packed(
            hstate, DataLoader(hg, train_nodes[: 2 * batch], sampler, batch,
                               seed=1, packed=True),
            feats, labels, fanouts)

        def host_epoch():
            nonlocal hstate
            hstate, l, _ = tr.run_epoch_packed(hstate, loader, feats, labels,
                                               fanouts)
            return l  # run_epoch_packed already syncs the loss total

        host_s, _ = timed_epochs(host_epoch)
        host_ms = host_s / len(loader) * 1e3
        detail["host_pipeline_packed"] = {
            "epoch_s": round(host_s, 3), "n_batches": len(loader),
            "batch_ms_incl_sampling": round(host_ms, 3),
            "vs_dgll_products_batch": round(6.12 / host_ms, 2),
        }

        # grouped dispatch: G batches scanned per launch — the RTT amortiser
        # (the reference hides producer latency with CUDA streams + queues,
        # buffer_queues.py:22-119; the XLA equivalent is fewer, bigger
        # launches)
        G = int(os.environ.get("BENCH_GROUP", 8))
        hstate, _, _ = tr.run_epoch_packed(
            hstate, DataLoader(hg, train_nodes[: 2 * G * batch], sampler, batch,
                               seed=2, packed=True),
            feats, labels, fanouts, group=G)

        def host_epoch_grouped():
            nonlocal hstate
            hstate, l, _ = tr.run_epoch_packed(hstate, loader, feats, labels,
                                               fanouts, group=G)
            return l

        hostg_s, _ = timed_epochs(host_epoch_grouped)
        hostg_ms = hostg_s / len(loader) * 1e3
        detail["host_pipeline_packed_grouped"] = {
            "group": G,
            "epoch_s": round(hostg_s, 3), "n_batches": len(loader),
            "batch_ms_incl_sampling": round(hostg_ms, 3),
            "vs_dgll_products_batch": round(6.12 / hostg_ms, 2),
            "vs_ungrouped": round(host_ms / hostg_ms, 2),
        }

        # r5: measured-link routing (group="auto") — must pick ~the better of
        # the two rows above on THIS link (VERDICT r4 ask #6: never ship a
        # silently-regressing grouped path)
        def host_epoch_auto():
            nonlocal hstate
            hstate, l, _ = tr.run_epoch_packed(hstate, loader, feats, labels,
                                               fanouts, group="auto")
            return l

        hosta_s, _ = timed_epochs(host_epoch_auto)
        hosta_ms = hosta_s / len(loader) * 1e3
        bw, rtt = tr._link
        detail["host_pipeline_packed_auto"] = {
            "chosen_group": tr.last_group,
            "probed_bandwidth_mb_s": round(bw / 1e6, 1),
            "probed_rtt_ms": round(rtt * 1e3, 2),
            "epoch_s": round(hosta_s, 3),
            "batch_ms_incl_sampling": round(hosta_ms, 3),
            "vs_dgll_products_batch": round(6.12 / hosta_ms, 2),
        }

    results = {
        "metric": "products_scale_epoch",
        "value": round(dev_s, 2),
        "unit": "s",
        "detail": detail,
    }
    print(json.dumps(results))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
