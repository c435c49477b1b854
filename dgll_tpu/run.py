"""Unified training CLI — ``python -m dgll_tpu.run --Model GCN --dataset synthetic ...``

Replaces the reference's per-model entry scripts (``MQGCN.py``, ``MQGraphSAGE.py``,
``MQFastGCN*.py``, ``MQLadies*.py``, ``CommGCN.py``, ``FeatureCache/gcn.py`` CLIs)
with one trainer driven by the shared flag set (``dgll_tpu/utils/config.py``).
Aggregates metric mean/std over ``--n_trial`` repeats like ``record_result_new``
(``GPU Accelerator/utils.py:38-99``).
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np


def build_dataset(cfg):
    from dgll_tpu.data import (
        gcn_normalize,
        load_graph,
        load_planetoid,
        synthetic_classification_graph,
    )

    if cfg.dataset == "synthetic":
        g = synthetic_classification_graph(
            n_node=cfg.n_node, avg_degree=cfg.avg_degree, n_class=cfg.n_class,
            feat_dim=cfg.feat_dim, power_law=1.0, seed=cfg.seed,
        )
    elif cfg.dataset.endswith(".graph") or cfg.dataset.endswith(".pkl"):
        g = load_graph(cfg.dataset)
    else:
        # planetoid directory containing <name>.content / <name>.cites
        import os

        path, name = os.path.split(cfg.dataset.rstrip("/"))
        g = load_planetoid(path or ".", name)
    return gcn_normalize(g)


def build_model(cfg, n_class: int):
    import jax.numpy as jnp

    from dgll_tpu.nn import GAT, GCN, GINNode, GraphSAGE

    dtype = {"float32": None, "bfloat16": jnp.bfloat16, "bf16": jnp.bfloat16}.get(
        cfg.dtype, None
    )
    if cfg.model.upper() == "GCN":
        return GCN(hidden=cfg.nhid, n_class=n_class, n_layers=cfg.n_layers,
                   dropout=cfg.dropout, dtype=dtype)
    if cfg.model.upper() == "GAT":
        return GAT(hidden=cfg.nhid, n_class=n_class, num_heads=cfg.n_heads,
                   n_layers=cfg.n_layers, dropout=cfg.dropout, dtype=dtype)
    if cfg.model.upper() in ("GRAPHSAGE", "SAGE"):
        return GraphSAGE(hidden=cfg.nhid, n_class=n_class, n_layers=cfg.n_layers,
                         aggregator=getattr(cfg, "sage_aggregator", "mean"),
                         combine=getattr(cfg, "sage_combine", "concat"),
                         dropout=cfg.dropout, dtype=dtype)
    if cfg.model.upper() == "GIN":
        return GINNode(hidden=cfg.nhid, n_class=n_class, n_layers=cfg.n_layers,
                       dropout=cfg.dropout, dtype=dtype)
    raise ValueError(f"unknown model {cfg.model!r}")


def build_sampler(cfg, g):
    from dgll_tpu.sampling import (
        FastGCNSampler,
        LadiesSampler,
        NeighborSampler,
        geometric_layer_sizes,
        normalized_laplacian,
    )

    if cfg.sampler == "neighbor":
        return NeighborSampler(cfg.fanouts, seed=cfg.seed)
    sizes = geometric_layer_sizes(cfg.n_samp, cfg.samp_growth_rate, cfg.n_layers)
    lap = normalized_laplacian(g)
    cls = FastGCNSampler if cfg.sampler == "fastgcn" else LadiesSampler
    return cls(lap, sizes, flatten=cfg.flatten, wrs=cfg.wrs, seed=cfg.seed)


def _device_sampling_graph(cfg, g, log):
    """Device graph object + per-layer sizes for ``--device_sampling``.

    ``neighbor``: HBM CSR + fanouts. ``fastgcn``/``ladies``: ELL-packed
    normalised Laplacian (``sampling/device_layerwise.py``) + geometric layer
    sizes from ``--n_samp``/``--samp_growth_rate`` — the same size schedule the
    host samplers use (ref ``MQFastGCNFlat.py:30-32``)."""
    from dgll_tpu.sampling import DeviceCSR, build_device_lap, geometric_layer_sizes

    if cfg.sampler == "neighbor":
        if cfg.window_sampling:
            log.info("device sampling: block-window mode (marginally "
                     "uniform, draws within a node correlated; "
                     "--no_window_sampling for exact per-slot draws)")
        return DeviceCSR.from_graph(g), cfg.fanouts
    sizes = geometric_layer_sizes(cfg.n_samp, cfg.samp_growth_rate, cfg.n_layers)
    if cfg.wrs:
        log.info("device layer-wise sampling draws WITH replacement "
                 "(multiplicity-weighted unbiased estimator); --wrs's "
                 "without-replacement draw is host-path only")
    return build_device_lap(g, k=32, flatten=cfg.flatten), sizes


def _exact_test_pred(cfg, model, params, g, feats, test_nodes):
    """Final-test predictions via full-neighborhood inference (--exact_eval).

    One compiled full-graph forward with the minibatch-trained params
    (``train/exact_infer.py``) — the reference's full-graph eval mode
    (``gcnconv.py:53-58``) — so reported accuracy carries no sampling noise."""
    import jax
    import jax.numpy as jnp

    from dgll_tpu.train.exact_infer import exact_predict

    feat_dtype = {"bfloat16": jnp.bfloat16, "bf16": jnp.bfloat16}.get(cfg.dtype)
    glight = g.replace(node_feat=None, labels=None, train_mask=None,
                       val_mask=None, test_mask=None)
    gd = jax.tree.map(jnp.asarray, glight)
    return exact_predict(model.apply, params, gd, feats, test_nodes,
                         feat_dtype=feat_dtype)


def _maybe_restore_params(cfg, params):
    """``--resume``: load the latest checkpointed params over the fresh init.

    Returns ``(params, resumed_step_or_None)``. Reference has no resume at all
    (best-model save commented out, ``CommGNN_train.py:156``); this wires
    ``CheckpointManager.restore`` into the CLI."""
    if not (cfg.resume and cfg.checkpoint_dir):
        return params, None
    import jax

    from dgll_tpu.train import CheckpointManager

    mgr = CheckpointManager(cfg.checkpoint_dir)
    step = mgr.latest_step()
    if step is None:
        mgr.close()
        return params, None
    restored = mgr.restore(jax.tree.map(np.asarray, params), step=step)
    mgr.close()
    return jax.tree.map(np.asarray, restored), int(step)


def _prepare_pipeline(cfg, g, model, n_class, timer, extra, log):
    """Shared COG / preprocess / cache preparation for every minibatch branch.

    Composes the reference's separately-shipped subsystems the way its end state
    intends (``MQGCN.py:94-163`` + ``FeatureCache/gcn.py:24-110`` +
    ``main_cog.py``): community relabeling first (contiguous id ranges), then
    optional offline neighbour-feature preprocessing, then the HBM feature cache
    over the (possibly relabeled, possibly widened) feature matrix. Returns
    ``(cfg, g, model, book, cache, fetch)``.
    """
    import numpy as np

    book = None
    if cfg.n_parts > 1:
        if cfg.sampler != "neighbor":
            raise ValueError("--n_parts > 1 requires --samp_type neighbor "
                             "(community-restricted neighbour sampling)")
        from dgll_tpu.parallel import run_cog

        cap = -(-g.n_real_node // cfg.n_parts)
        d_feat = int(np.asarray(g.node_feat).shape[1])
        budget = cap * (d_feat * 4 + 4)
        with timer.phase("cog"):
            g, book, cog_t = run_cog(
                g, hbm_budget_bytes=budget,
                batch_size=min(cfg.batch_size, cap), seed=cfg.seed,
            )
        extra["n_communities"] = len(book)
        extra["cog_s"] = float(sum(cog_t.values()))
        log.info(f"COG: {len(book)} communities in {extra['cog_s']:.2f}s")

    # ---- offline neighbour-feature preprocessing (ref gs.py:43-56): the
    # precomputed mean-aggregated 'neigh' field rides along with the raw
    # features and replaces the outermost sampled hop.
    if cfg.preprocess:
        from dataclasses import replace as _dc_replace

        from dgll_tpu.data.transforms import precompute_neighbor_features

        neigh = precompute_neighbor_features(g)
        if g.n_node > g.n_real_node:  # keep padded rows padded
            neigh = np.pad(neigh, ((0, g.n_node - g.n_real_node), (0, 0)))
        x_cat = np.concatenate(
            [np.asarray(g.node_feat, np.float32), neigh], axis=1
        )
        g = g.with_features(node_feat=x_cat)
        if len(cfg.fanouts) > 1:
            cfg = _dc_replace(cfg, fanouts=list(cfg.fanouts[1:]),
                              n_layers=max(cfg.n_layers - 1, 1))
            model = build_model(cfg, n_class)
        extra["preprocess"] = True

    # ---- HBM feature cache (ref GraphCacheServer flow, FeatureCache/gcn.py):
    # --cached_nPercent of nodes, top out-degree policy; misses from host.
    cache = None
    fetch = None
    if cfg.cached_percent > 0:
        from dgll_tpu.cache import HBMFeatureCache

        host_feats = np.asarray(g.node_feat, np.float32)
        cache = HBMFeatureCache(host_feats)
        k = int(cfg.cached_percent / 100.0 * g.n_real_node)
        budget = k * host_feats.shape[1] * host_feats.itemsize
        cache.auto_cache(g.out_degrees_np(), budget)
        fetch = lambda ids: cache.fetch(np.asarray(ids))
        log.info(f"cache: {cache.k}/{g.n_real_node} rows resident")
    return cfg, g, model, book, cache, fetch



def _finalize_trial(cfg, timer, t_start, extra, test_acc, f1, best_val,
                    n_epochs_run, final_params):
    """Shared trial epilogue: checkpoint save + per-dataset headline metric +
    result dict (single source of truth for every branch)."""
    import jax

    from dgll_tpu.train.metrics import metric_for_dataset

    total = time.perf_counter() - t_start
    if cfg.checkpoint_dir:
        from dgll_tpu.train import CheckpointManager

        save_step = n_epochs_run + (extra.get("resumed_from") or 0)
        mgr = CheckpointManager(cfg.checkpoint_dir)
        mgr.save(save_step, jax.tree.map(np.asarray, final_params), wait=True)
        mgr.close()
    metric_name = metric_for_dataset(cfg.dataset)
    metric_value = {"acc": test_acc, "f1": f1}.get(metric_name, test_acc)
    return {
        "test_acc": float(test_acc),
        "micro_f1": float(f1),
        "metric_name": metric_name,
        "metric": float(metric_value),
        "best_val": float(best_val),
        "epochs": n_epochs_run,
        "train_s": timer.totals.get("train", total),
        "total_s": total,
        **extra,
    }


def _run_dp_trial(cfg, g, trial_seed: int, model, tx, timer, log,
                  book=None, fetch=None) -> dict:
    """Data-parallel minibatch training over ``--n_devices`` mesh devices, sync or
    one-step-stale (``--async_dp``) gradient application. ``book`` routes each
    community's contiguous id range through its own community-restricted sharded
    loader (COG composition); ``fetch`` overrides the feature gather with the
    HBM cache (cache composition) — together this is the reference's flagship
    MQ-GNN + FeatureCache + COG pipeline in one jitted mesh program."""
    import jax
    import jax.numpy as jnp

    from dgll_tpu.dataloader import DataLoader
    from dgll_tpu.parallel import (
        ShardedDataLoader,
        make_async_dp_block_step,
        make_dp_block_step,
        make_mesh,
    )
    from dgll_tpu.sampling import HostGraph
    from dgll_tpu.train import MiniBatchTrainer

    if cfg.sampler != "neighbor" and not (
            cfg.device_sampling and cfg.sampler in ("fastgcn", "ladies")):
        raise ValueError(
            "--n_devices > 1 requires --samp_type neighbor (host sampling), or "
            "--device_sampling with neighbor|fastgcn|ladies")
    D = cfg.n_devices
    devices = jax.devices()[:D]
    assert len(devices) == D, f"need {D} devices, have {len(jax.devices())}"
    mesh = make_mesh(("data",), devices=devices)

    hg = HostGraph.from_graph(g)
    sampler = build_sampler(cfg, g)
    per_dev = max(cfg.batch_size // D, 1)
    train_nodes = g.get_train_nodes()

    if cfg.device_sampling:
        # ---- DP x on-device sampling: every device samples its sub-batch
        # from the replicated HBM CSR inside the scanned epoch (psum grads)
        if book is not None or fetch is not None:
            raise ValueError(
                "--device_sampling keeps the graph and features HBM-resident; "
                "it composes with neither --n_parts nor --cached_nPercent")
        from dgll_tpu.train import DeviceDPEpochRunner, micro_f1

        dgraph, sizes = _device_sampling_graph(cfg, g, log)
        feats_d = jnp.asarray(g.node_feat)
        labels_d = jnp.asarray(g.labels)
        runner = DeviceDPEpochRunner(
            model, tx, dgraph, sizes, per_dev, train_nodes, mesh,
            seed=trial_seed, window=cfg.window_sampling, sampler=cfg.sampler)
        state = runner.init_state(feats_d)
        params0, resumed = _maybe_restore_params(cfg, state.params)
        if resumed is not None:
            state = state.replace(params=jax.tree.map(jnp.asarray, params0))
        # compiled eval sweep — no host DataLoader in the device-sampling flow
        labels_np = np.asarray(g.labels)
        val_nodes = g.get_validation_nodes()
        best_val, bad, n_epochs_run = -np.inf, 0, 0
        loss = np.inf
        for epoch in range(cfg.n_epochs):
            with timer.phase("train"):
                state, loss = runner.run_epoch(state, feats_d, labels_d)
                loss = float(loss)
            n_epochs_run += 1
            with timer.phase("validate"):
                val = runner.evaluate_nodes(state, feats_d, labels_np,
                                            val_nodes, seed=trial_seed + 1)
            if val > best_val:
                best_val, bad = val, 0
            else:
                bad += 1
            log.info(f"[dp x{D} device-sampling] epoch {epoch} "
                     f"loss {loss:.4f} val {val:.4f}")
            if cfg.n_stops and bad >= cfg.n_stops:
                break
        test_nodes = np.asarray(g.get_test_nodes(), np.int64)
        if cfg.exact_eval:
            pred = _exact_test_pred(cfg, model, state.params, g, feats_d,
                                    test_nodes)
        else:
            pred = runner.predict_nodes(state, feats_d, test_nodes,
                                        seed=trial_seed + 2)
        y = labels_np[test_nodes]
        return {
            "test_acc": float((pred == y).mean()) if len(pred) else 0.0,
            "micro_f1": micro_f1(pred, y),
            "best_val": float(best_val),
            "epochs": n_epochs_run,
            "params": state.params,
            "extra": {"n_devices": D, "async_dp": False,
                      "device_sampling": True,
                      "window_sampling": bool(cfg.window_sampling),
                      "exact_eval": bool(cfg.exact_eval),
                      "resumed_from": resumed},
        }

    if book is not None:
        from dgll_tpu.sampling import CommunityNeighborSampler

        # ONE shared per-device batch size across communities: distinct block
        # shapes would retrace/recompile the DP step per community. bc is
        # sized so the largest community
        # trains at full batch; communities with fewer than one bc*D step of
        # seeds are skipped (logged) rather than shrinking the shapes.
        per_comm = [
            train_nodes[(train_nodes >= lo) & (train_nodes < hi)]
            for lo, hi in book.values()
        ]
        largest = max((len(sc) for sc in per_comm), default=0)
        bc = max(1, min(per_dev, largest // D))
        loaders = []
        skipped = 0
        for (lo, hi), seeds_c in zip(book.values(), per_comm):
            if len(seeds_c) < bc * D:
                skipped += len(seeds_c)
                continue
            cs = CommunityNeighborSampler(cfg.fanouts, (lo, hi), seed=cfg.seed)
            loaders.append(ShardedDataLoader(hg, seeds_c, cs, bc, D,
                                             seed=trial_seed))
        if skipped:
            log.info(f"community DP: skipped {skipped} train seeds in "
                     f"communities smaller than one step ({bc * D}); one "
                     f"shared per-device batch {bc} keeps a single compile")
    else:
        loaders = [ShardedDataLoader(hg, train_nodes, sampler, per_dev, D,
                                     seed=trial_seed)]
    loaders = [l for l in loaders if len(l) > 0]
    if not loaders:
        raise ValueError(
            f"batch_size {cfg.batch_size} over {D} devices needs at least "
            f"{per_dev * D} train seeds per (community) loader; have "
            f"{len(train_nodes)} — lower --batch_size or raise the train split"
        )
    # with the HBM cache active, x gathers go through fetch(); uploading the
    # full [N, d] matrix as well would double-allocate the memory the cache
    # exists to save
    feats = None if fetch is not None else jnp.asarray(g.node_feat)
    labels = jnp.asarray(g.labels)

    use_dropout = cfg.dropout > 0

    def model_apply(p, blocks, x, rng):
        if use_dropout:
            return model.apply({"params": p}, blocks, x, deterministic=False,
                               rngs={"dropout": rng})
        return model.apply({"params": p}, blocks, x, deterministic=True)

    outs, blocks0 = next(iter(loaders[0]))
    local = jax.tree.map(lambda a: a[0], blocks0,
                         is_leaf=lambda a: isinstance(a, jax.Array))
    if fetch is not None:
        x0 = fetch(np.asarray(local[0].src_ids))
    else:
        x0 = jnp.take(feats, local[0].src_ids, axis=0)
    params = model.init(jax.random.key(trial_seed), local, x0)["params"]
    params, resumed = _maybe_restore_params(cfg, params)
    opt_state = tx.init(params)
    if cfg.async_dp:
        step, init_grads = make_async_dp_block_step(mesh, model_apply, tx)
        grads = init_grads(params)
    else:
        step = make_dp_block_step(mesh, model_apply, tx)

    # single-device eval path reuses the MiniBatchTrainer machinery
    ev = MiniBatchTrainer(model, tx, seed=trial_seed)
    val_loader = DataLoader(g, g.get_validation_nodes(), sampler, cfg.batch_size,
                            shuffle=False, seed=trial_seed + 1)

    def gather(blocks):
        # src_ids/dst_ids are already [D, n] stacked -> one batched gather each
        sid = blocks[0].src_ids
        if fetch is not None:  # HBM cache path: hits from device, misses host
            d, n = sid.shape
            x = fetch(np.asarray(sid).reshape(-1)).reshape(d, n, -1)
        else:
            x = jnp.take(feats, sid, axis=0)
        y = jnp.take(labels, blocks[-1].dst_ids, axis=0)
        return x, y, blocks[-1].dst_mask

    best_val, bad, n_epochs_run = -np.inf, 0, 0
    base_rng = jax.random.key(trial_seed)
    step_i = 0
    loss = np.inf
    for epoch in range(cfg.n_epochs):
        with timer.phase("train"):
            for loader in loaders:
                for outs, blocks in loader:
                    x, y, m = gather(blocks)
                    rng = jax.random.fold_in(base_rng, step_i)  # fresh dropout
                    step_i += 1
                    if cfg.async_dp:
                        params, opt_state, grads, loss = step(
                            params, opt_state, grads, blocks, x, y, m, rng)
                    else:
                        params, opt_state, loss = step(params, opt_state, blocks,
                                                       x, y, m, rng)
        n_epochs_run += 1
        with timer.phase("validate"):
            from dgll_tpu.train.trainer import TrainState

            st = TrainState.create(apply_fn=model.apply, params=params, tx=tx)
            val = ev.evaluate_nodes(st, val_loader, feats, labels,
                                    fetch_fn=fetch)
        if val > best_val:
            best_val, bad = val, 0
        else:
            bad += 1
        log.info(f"[dp x{D}{' async' if cfg.async_dp else ''}] epoch {epoch} "
                 f"loss {float(loss):.4f} val {val:.4f}")
        if cfg.n_stops and bad >= cfg.n_stops:
            break
    if cfg.async_dp:
        # flush the final stale gradients
        updates, opt_state = tx.update(grads, opt_state, params)
        import optax as _optax

        params = _optax.apply_updates(params, updates)

    from dgll_tpu.train.trainer import TrainState

    st = TrainState.create(apply_fn=model.apply, params=params, tx=tx)
    test_loader = DataLoader(g, g.get_test_nodes(), sampler, cfg.batch_size,
                             shuffle=False, seed=trial_seed + 2)
    pred, y = ev.predict_nodes(st, test_loader, feats, labels, fetch_fn=fetch)
    from dgll_tpu.train import micro_f1

    return {
        "test_acc": float((pred == y).mean()) if len(pred) else 0.0,
        "micro_f1": micro_f1(pred, y),
        "best_val": float(best_val),
        "epochs": n_epochs_run,
        "params": params,
        "extra": {"n_devices": D, "async_dp": bool(cfg.async_dp),
                  "resumed_from": resumed},
    }


def run_trial(cfg, g, trial_seed: int) -> dict:
    import jax
    import optax

    from dgll_tpu.train import (
        FullBatchTrainer,
        MiniBatchTrainer,
        accuracy,
        macro_f1,
        micro_f1,
    )
    from dgll_tpu.train.metrics import metric_for_dataset
    from dgll_tpu.utils import PhaseTimer, get_logger

    log = get_logger(cfg.log_file)
    timer = PhaseTimer()
    n_class = int(np.asarray(g.labels)[: g.n_real_node].max()) + 1
    model = build_model(cfg, n_class)
    tx = (
        optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
        if cfg.weight_decay
        else optax.adam(cfg.lr)
    )

    t_start = time.perf_counter()
    extra: dict = {}
    if cfg.sampler == "full":
        import jax.numpy as jnp

        from dgll_tpu.train.trainer import create_train_state

        tr = FullBatchTrainer(model, tx, seed=trial_seed)
        state0 = None
        if cfg.resume and cfg.checkpoint_dir:
            gd = jax.tree.map(jnp.asarray, g)
            tr.rng, init_rng = jax.random.split(tr.rng)
            state0 = create_train_state(model, init_rng, tx, gd, gd.node_feat)
            p, resumed = _maybe_restore_params(cfg, state0.params)
            if resumed is not None:
                state0 = state0.replace(params=jax.tree.map(jnp.asarray, p))
                extra["resumed_from"] = resumed
        with timer.phase("train"):
            state, hist = tr.fit(
                g, g.node_feat, g.labels, g.train_mask, g.val_mask,
                epochs=cfg.n_epochs, patience=cfg.n_stops, state=state0,
            )
        logp = tr.evaluate(state, g, g.node_feat)
        test_acc = accuracy(logp, g.labels, g.test_mask)
        f1 = micro_f1(np.asarray(logp).argmax(-1), np.asarray(g.labels),
                      np.asarray(g.test_mask))
        best_val = hist.best_val
        n_epochs_run = len(hist.epochs)
        final_params = state.params
    elif cfg.n_devices > 1:
        # ---- composed flagship: COG + cache + preprocess prepared once, then
        # data-parallel minibatch over the mesh (ref MQGCN.py:94-163 flow
        # composed with FeatureCache/gcn.py + main_cog.py); --async_dp applies
        # one-step-stale gradients (RaCoM twin).
        cfg, g, model, book, cache, fetch = _prepare_pipeline(
            cfg, g, model, n_class, timer, extra, log)
        r = _run_dp_trial(cfg, g, trial_seed, model, tx, timer, log,
                          book=book, fetch=fetch)
        test_acc = r["test_acc"]
        f1 = r["micro_f1"]
        best_val = r["best_val"]
        n_epochs_run = r["epochs"]
        final_params = r["params"]
        extra.update(r["extra"])
        if cache is not None:
            rate, lookups, misses = cache.miss_rate()
            extra["cache_miss_rate"] = float(rate)
            extra["cache_lookups"] = int(lookups)
            extra["cached_rows"] = int(cache.k)
    else:
        import jax.numpy as jnp

        from dgll_tpu.dataloader import DataLoader

        cfg, g, model, book, cache, fetch = _prepare_pipeline(
            cfg, g, model, n_class, timer, extra, log)
        sampler = build_sampler(cfg, g)
        train_nodes = g.get_train_nodes()

        if cfg.device_sampling:
            # ---- fully device-resident pipeline: graph + features in HBM,
            # sampling inside the jitted program, one dispatch per epoch
            # (train/device_pipeline.py — the fastest single-chip path).
            # Uniform neighbour fanout AND the layer-wise importance samplers
            # (FastGCN/LADIES, sampling/device_layerwise.py) both run in-jit.
            if cfg.sampler not in ("neighbor", "fastgcn", "ladies"):
                raise ValueError(
                    "--device_sampling supports --samp_type neighbor|fastgcn|ladies")
            if book is not None or fetch is not None:
                raise ValueError(
                    "--device_sampling keeps the graph and features HBM-resident; "
                    "it composes with neither --n_parts nor --cached_nPercent "
                    "(use the host pipeline for those, or DP for scale-out)")
            from dgll_tpu.train import DeviceEpochRunner

            dgraph, sizes = _device_sampling_graph(cfg, g, log)
            feats = jnp.asarray(g.node_feat)
            labels = jnp.asarray(g.labels)
            runner = DeviceEpochRunner(
                model, tx, dgraph, sizes, cfg.batch_size, train_nodes,
                seed=trial_seed, window=cfg.window_sampling,
                sampler=cfg.sampler)
            state = runner.init_state(feats)
            p, resumed = _maybe_restore_params(cfg, state.params)
            if resumed is not None:
                state = state.replace(params=jax.tree.map(jnp.asarray, p))
                extra["resumed_from"] = resumed
            # validation/test ride the COMPILED eval sweep (one dispatch per
            # set; no host DataLoader in any device-sampling flow)
            labels_np = np.asarray(g.labels)
            val_nodes = g.get_validation_nodes()
            best_val, bad, n_epochs_run = -np.inf, 0, 0
            loss = np.inf
            for epoch in range(cfg.n_epochs):
                with timer.phase("train"):
                    state, loss = runner.run_epoch(state, feats, labels)
                    loss = float(loss)
                n_epochs_run += 1
                with timer.phase("validate"):
                    val = runner.evaluate_nodes(state, feats, labels_np,
                                                val_nodes, seed=trial_seed + 1)
                if val > best_val:
                    best_val, bad = val, 0
                else:
                    bad += 1
                log.info(f"[device] epoch {epoch} loss {loss:.4f} val {val:.4f}")
                if cfg.n_stops and bad >= cfg.n_stops:
                    break
            test_nodes = np.asarray(g.get_test_nodes(), np.int64)
            if cfg.exact_eval:
                pred = _exact_test_pred(cfg, model, state.params, g, feats,
                                        test_nodes)
            else:
                pred = runner.predict_nodes(state, feats, test_nodes,
                                            seed=trial_seed + 2)
            y = labels_np[test_nodes]
            test_acc = float((pred == y).mean()) if len(pred) else 0.0
            f1 = micro_f1(pred, y)
            final_params = state.params
            extra["device_sampling"] = True
            extra["window_sampling"] = bool(cfg.window_sampling)
            extra["exact_eval"] = bool(cfg.exact_eval)
            return _finalize_trial(cfg, timer, t_start, extra, test_acc, f1,
                                   best_val, n_epochs_run, final_params)

        if book is not None:
            from dgll_tpu.sampling import CommunityNeighborSampler

            loaders = []
            for cid, (lo, hi) in book.items():
                seeds_c = train_nodes[(train_nodes >= lo) & (train_nodes < hi)]
                if len(seeds_c) == 0:
                    continue
                bsz = min(cfg.batch_size, max(len(seeds_c), 1))
                cs = CommunityNeighborSampler(cfg.fanouts, (lo, hi), seed=cfg.seed)
                loaders.append(DataLoader(g, seeds_c, cs, bsz, seed=trial_seed))
        else:
            loaders = [DataLoader(g, train_nodes, sampler, cfg.batch_size,
                                  seed=trial_seed)]

        tr = MiniBatchTrainer(model, tx, seed=trial_seed)
        l0 = loaders[0]
        _, _, b0 = l0.sampler.sample(l0.host_g, l0.seeds[: l0.batch_size],
                                     pad_to=l0.batch_size)
        feats = jnp.asarray(g.node_feat)
        labels = jnp.asarray(g.labels)
        x0 = jnp.take(feats, jnp.asarray(b0[0].src_ids), axis=0)
        state = tr.init_state(b0, x0)
        p, resumed = _maybe_restore_params(cfg, state.params)
        if resumed is not None:
            state = state.replace(params=jax.tree.map(jnp.asarray, p))
            extra["resumed_from"] = resumed
        best_val, bad, n_epochs_run = -np.inf, 0, 0
        val_loader = DataLoader(g, g.get_validation_nodes(), sampler, cfg.batch_size,
                                shuffle=False, seed=trial_seed + 1)
        for epoch in range(cfg.n_epochs):
            with timer.phase("train"):
                losses, dt = [], 0.0
                for loader in loaders:
                    state, loss, d = tr.run_epoch(state, loader, feats, labels,
                                                  fetch_fn=fetch)
                    losses.append(loss)
                    dt += d
                loss = float(np.mean(losses))
            n_epochs_run += 1
            with timer.phase("validate"):
                val = tr.evaluate_nodes(state, val_loader, feats, labels,
                                        fetch_fn=fetch)
            if val > best_val:
                best_val, bad = val, 0
            else:
                bad += 1
            log.info(f"epoch {epoch} loss {loss:.4f} val {val:.4f} ({dt:.2f}s)")
            if cfg.n_stops and bad >= cfg.n_stops:
                break
        if cfg.exact_eval:
            test_nodes = np.asarray(g.get_test_nodes(), np.int64)
            pred = _exact_test_pred(cfg, model, state.params, g, feats,
                                    test_nodes)
            y = np.asarray(g.labels)[test_nodes]
            extra["exact_eval"] = True
        else:
            test_loader = DataLoader(g, g.get_test_nodes(), sampler,
                                     cfg.batch_size, shuffle=False,
                                     seed=trial_seed + 2)
            pred, y = tr.predict_nodes(state, test_loader, feats, labels,
                                       fetch_fn=fetch)
        test_acc = float((pred == y).mean()) if len(pred) else 0.0
        f1 = micro_f1(pred, y)
        final_params = state.params
        if cache is not None:
            rate, lookups, misses = cache.miss_rate()
            extra["cache_miss_rate"] = float(rate)
            extra["cache_lookups"] = int(lookups)
            extra["cached_rows"] = int(cache.k)

    # headline metric chosen per dataset (ref GPU Accelerator/utils.py:60-91)
    return _finalize_trial(cfg, timer, t_start, extra, test_acc, f1,
                           best_val, n_epochs_run, final_params)


def main(argv=None) -> dict:
    from dgll_tpu.utils import parse_train_config

    cfg = parse_train_config(argv)
    g = build_dataset(cfg)
    results = [run_trial(cfg, g, cfg.seed + t) for t in range(cfg.n_trial)]
    agg = {
        k: {
            "mean": float(np.mean([r[k] for r in results])),
            "std": float(np.std([r[k] for r in results])),
        }
        for k in results[0]
        if isinstance(results[0][k], (int, float)) and results[0][k] is not None
        and not isinstance(results[0][k], bool)
    }
    out = {"config": vars(cfg) | {"fanouts": list(cfg.fanouts)}, "trials": results,
           "aggregate": agg}
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    from dgll_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
