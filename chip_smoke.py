"""On-card smoke test: drive the main paths once at full width on the GPU and
check them against plain references. Run from the repository root:

    python chip_smoke.py             # one card: phases 0-4
    python chip_smoke.py --chips 4   # four cards: the multi-card paths only

Phases (one process; any failure exits non-zero before the result line):

0. device: the GPU, its ``nvidia-smi`` name and power limit, the compile cache;
1. minibatch GraphSAGE through ``DeviceEpochRunner`` at ogbn-products shape
   (2.4M nodes, ~60M edges, 100-d features, hidden 256, fanouts [15,10],
   batch 1024): block-window sampling, then per-slot; loss finite and falling;
2. one host-sampled batch: forward and gradient on the GPU against the CPU;
3. full graph (200k nodes, degree 16, clustered, widths 128): ``spmm_coo``
   against ``scipy.sparse`` in float64, one GCN and one GAT (8x8) layer on
   the GPU against the CPU, and GCN/GAT train steps through
   ``FullBatchTrainer``, with their times and device-memory bound shares;
4. the CLI, ``dgll_tpu.run.main``, with device sampling and full-graph GCN.

``--chips 4`` runs, on a 1-D ``("data",)`` mesh over four cards: the DP
device-sampling epoch at products shape, ``make_dp_block_step`` against the
same batch on one card, halo and all-gather ``make_partitioned_spmm`` against
``spmm_coo`` on one card, and one partition-parallel GCN step.

GPU-against-CPU comparisons run under ``jax.default_matmul_precision("highest")``
(f32 matmuls would otherwise run as TF32) with rtol 1e-4 / atol 1e-5 times the
array's scale: only the order of the (atomic) sums differs. The difference at
default precision is printed, not asserted. The last line of output is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import scipy.sparse as sp

from bench import clustered_graph, power_law_csr
from benchmarks.peaks import aggregation_bytes, bound_share, card_name_and_power_limit
from dgll_tpu import run
from dgll_tpu.data import gcn_normalize
from dgll_tpu.nn import GAT, GCN, GATConv, GCNConv, GraphSAGE
from dgll_tpu.ops import spmm_coo
from dgll_tpu.parallel import (
    make_dp_block_step,
    make_gp_gcn_train_step,
    make_mesh,
    make_partitioned_spmm,
    partition_graph,
    shard_partitioned_graph,
    stack_block_lists,
)
from dgll_tpu.sampling import DeviceCSR, HostGraph, NeighborSampler
from dgll_tpu.train import DeviceDPEpochRunner, DeviceEpochRunner, FullBatchTrainer
from dgll_tpu.train.metrics import masked_nll_loss
from dgll_tpu.utils import enable_compile_cache

RTOL, ATOL = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, iters: int) -> float:
    """Seconds per call of ``fn()``, after one warm call; the window ends in
    ``block_until_ready``."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _max_rel(a, b) -> float:
    """Largest |a-b| over the largest |b| (relative to the array's scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_close(name: str, got, ref) -> None:
    """rtol RTOL; atol ATOL relative to the array's scale (at least 1): a sum's
    rounding error grows with the size of its terms, not of its result, so a
    near-zero entry of a large-scale gradient carries the scale's error."""
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    for (path, g), r in zip(got, jax.tree.leaves(ref)):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1.0) if r.size else 1.0
        np.testing.assert_allclose(np.asarray(g), r, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=f"{name}{jax.tree_util.keystr(path)}")


def _against_cpu(name: str, fn, args) -> dict:
    """``fn(*args)`` on the default device against the CPU: asserted under
    "highest" matmul precision, reported (not asserted) at the default."""
    cpu, dev = jax.devices("cpu")[0], jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        ref = fn(*jax.device_put(args, cpu))
        got = fn(*jax.device_put(args, dev))
    got_default = fn(*jax.device_put(args, dev))
    _assert_close(name, got, ref)

    def worst(out):
        return max(_max_rel(a, b)
                   for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)))

    return {"max_rel_highest": worst(got), "max_rel_default": worst(got_default)}


def _peak_bytes(dev) -> str:
    stats = dev.memory_stats()
    return "not reported" if not stats else str(stats.get("peak_bytes_in_use"))


def _learnable_labels(feats, n_class: int, seed: int):
    """Labels a model can learn: argmax of a fixed random projection."""
    proj = jax.random.normal(jax.random.key(seed), (feats.shape[1], n_class))
    return jnp.argmax(feats @ proj, axis=-1).astype(jnp.int32)


# ---------------------------------------------------------------- phase 0
def phase_device(n_chips: int):
    """The GPU and the compile cache; exits non-zero without a GPU."""
    cache_dir = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < n_chips:
        raise SystemExit(f"--chips {n_chips}: JAX found {len(devs)} device(s)")
    log(f"[0] card: {card_name_and_power_limit()}")
    log(f"[0] device_kind={devs[0].device_kind} count={len(devs)} "
        f"compile_cache={cache_dir}")
    return devs


def count_cache_events():
    """Counts of persistent-compile-cache hits and misses from now on."""
    counts = {"hits": 0, "misses": 0}
    names = {"/jax/compilation_cache/cache_hits": "hits",
             "/jax/compilation_cache/cache_misses": "misses"}

    def listener(event, **kwargs):
        if event in names:
            counts[names[event]] += 1

    jax.monitoring.register_event_listener(listener)
    return counts


# ---------------------------------------------------------------- phase 1
def products_like(n_node: int, avg_deg: int, feat_dim: int, n_class: int,
                  seed: int = 0):
    """Host CSR of a power-law graph plus device features and learnable labels."""
    indptr, src = power_law_csr(n_node, avg_deg, seed=seed)
    feats = jax.random.normal(jax.random.key(seed), (n_node, feat_dim))
    labels = _learnable_labels(feats, n_class, seed + 1)
    return indptr, src, feats, labels


def phase_minibatch(indptr, src, feats, labels, n_class: int, hidden: int = 256,
                    fanouts=(15, 10), batch: int = 1024,
                    train_frac: float = 0.08) -> dict:
    """GraphSAGE epochs through DeviceEpochRunner: block-window, then per-slot
    sampling, each one warm-up epoch and one timed epoch."""
    n_node = len(indptr) - 1
    rng = np.random.default_rng(0)
    train_nodes = rng.choice(n_node, max(int(train_frac * n_node), batch),
                             replace=False)
    csr = DeviceCSR.from_host_arrays(indptr, src)
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)
    out, state = {}, None
    for window in (True, False):
        runner = DeviceEpochRunner(model, optax.adam(1e-3), csr, list(fanouts),
                                   batch, train_nodes, seed=0, window=window)
        if state is None:
            state = runner.init_state(feats)
        t0 = time.perf_counter()
        state, warm = jax.block_until_ready(runner.run_epoch(state, feats, labels))
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, loss = jax.block_until_ready(runner.run_epoch(state, feats, labels))
        ms = (time.perf_counter() - t0) / runner.n_batches * 1e3
        warm, loss = float(warm), float(loss)
        mode = "window" if window else "per_slot"
        log(f"[1] {mode}: {ms:.4f} ms/batch over {runner.n_batches} batches, "
            f"first epoch incl. compile {warm_s:.2f} s, loss {warm:.4f} -> {loss:.4f}")
        if not (np.isfinite(loss) and loss < warm):
            raise AssertionError(f"{mode}: loss did not fall ({warm} -> {loss})")
        out[mode] = {"ms_per_batch": ms, "loss": loss, "first_epoch_s": warm_s}
    out["peak_bytes_in_use"] = _peak_bytes(jax.devices()[0])
    log(f"[1] peak_bytes_in_use={out['peak_bytes_in_use']}")
    return out


# ---------------------------------------------------------------- phase 2
def phase_parity(indptr, src, feats, labels, n_class: int, hidden: int = 256,
                 fanouts=(15, 10), batch: int = 1024) -> dict:
    """One host-sampled GraphSAGE batch: loss, log-probs and gradients on the
    default device against the CPU."""
    hg = HostGraph(indptr, src, len(indptr) - 1)
    seeds = np.random.default_rng(2).choice(hg.n_node, batch, replace=False)
    _, _, blocks = NeighborSampler(list(fanouts), seed=0).sample(hg, seeds,
                                                                pad_to=batch)
    x = np.asarray(jnp.take(feats, jnp.asarray(blocks[0].src_ids), axis=0))
    y = np.asarray(jnp.take(labels, jnp.asarray(blocks[-1].dst_ids), axis=0))
    m = np.asarray(blocks[-1].dst_mask)
    blocks = jax.tree.map(np.asarray, blocks)
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.key(0), blocks, x)["params"])

    @jax.jit
    def fwd_bwd(p, blocks, x, y, m):
        def loss_of(p):
            logp = model.apply({"params": p}, list(blocks), x)
            return masked_nll_loss(logp, y, m), logp

        (loss, logp), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        return loss, logp, grads

    res = _against_cpu("minibatch", fwd_bwd, (params, tuple(blocks), x, y, m))
    log(f"[2] minibatch fwd+grad vs CPU: max rel diff "
        f"{res['max_rel_highest']:.3e} (highest), "
        f"{res['max_rel_default']:.3e} (default precision, not asserted)")
    return res


# ---------------------------------------------------------------- phase 3
def fullgraph_graph(n_node: int, avg_deg: int, width: int, n_class: int):
    """Section-B graph: clustered, GCN-normalised, on the device, with
    learnable labels."""
    g = gcn_normalize(clustered_graph(n_node, avg_deg, width, n_class))
    labels = np.asarray(_learnable_labels(jnp.asarray(g.node_feat), n_class, 5))
    return g.replace(labels=labels).to_device()


def check_spmm(g, width: int, iters: int = 20) -> dict:
    """``spmm_coo`` against scipy in float64 (per-row relative error), and its
    forward and backward times with device-memory bound shares."""
    n, e = g.n_node, g.n_real_edge
    x = jax.random.normal(jax.random.key(3), (n, width))
    fwd = jax.jit(lambda x: spmm_coo(g.src, g.dst, x, n, g.edge_weight))
    out = np.asarray(fwd(x), np.float64)
    a = sp.csr_matrix((np.asarray(g.edge_weight, np.float64),
                       (np.asarray(g.dst), np.asarray(g.src))), shape=(n, n))
    ref = a @ np.asarray(x, np.float64)
    row_err = (np.linalg.norm(out - ref, axis=1)
               / np.maximum(np.linalg.norm(ref, axis=1), 1e-30))
    worst = float(row_err.max())
    if worst > 1e-5:
        raise AssertionError(f"spmm_coo vs scipy: per-row rel error {worst:.3e}")

    bwd = jax.jit(lambda x, ct: jax.vjp(fwd, x)[1](ct)[0])
    ct = jnp.ones((n, width), jnp.float32)
    t_fwd = _timed(lambda: fwd(x), iters)
    t_bwd = _timed(lambda: bwd(x, ct), iters)
    res = {"max_row_rel_err": worst, "fwd_ms": t_fwd * 1e3, "bwd_ms": t_bwd * 1e3}
    kind = jax.devices()[0].device_kind
    if jax.devices()[0].platform == "gpu":
        nbytes = aggregation_bytes(e, n, width, 4)
        res["fwd_bound_share"] = bound_share(nbytes, t_fwd, kind)
        res["bwd_bound_share"] = bound_share(nbytes, t_bwd, kind)
    log(f"[3] spmm_coo F={width} E={e}: per-row rel err vs scipy f64 {worst:.3e}; "
        + " ".join(f"{k}={v:.4f}" for k, v in res.items() if k != "max_row_rel_err"))
    return res


def check_layers(g, width: int, heads: int = 8, head_dim: int = 8) -> dict:
    """One GCNConv and one GATConv: forward and parameter/input gradients on the
    default device against the CPU."""
    x = jax.random.normal(jax.random.key(4), (g.n_node, width))
    res = {}
    for name, layer in (("gcn", GCNConv(width)),
                        ("gat", GATConv(head_dim, num_heads=heads))):
        params = layer.init(jax.random.key(0), g, x)["params"]
        ct = jax.random.normal(jax.random.key(5), (g.n_node, layer.features * (
            heads if name == "gat" else 1)))

        @jax.jit
        def fwd_bwd(p, g, x, ct, layer=layer):
            out, vjp = jax.vjp(lambda p, x: layer.apply({"params": p}, g, x), p, x)
            return out, vjp(ct)

        res[name] = _against_cpu(name, fwd_bwd, jax.tree.map(
            np.asarray, (params, g, x, ct)))
        log(f"[3] {name} layer fwd+grad vs CPU: max rel diff "
            f"{res[name]['max_rel_highest']:.3e} (highest), "
            f"{res[name]['max_rel_default']:.3e} (default, not asserted)")
    return res


def train_steps(g, width: int, n_class: int, steps: int = 10) -> dict:
    """GCN and GAT (8 heads x 8) train steps through FullBatchTrainer: time per
    step, loss falling, aggregation-bytes bound share."""
    e, n = g.n_real_edge, g.n_node
    models = {
        "gcn": (GCN(hidden=width, n_class=n_class, dropout=0.0),
                2 * aggregation_bytes(e, n, width, 4)
                + 2 * aggregation_bytes(e, n, n_class, 4)),
        "gat": (GAT(hidden=8, n_class=n_class, num_heads=8),
                2 * aggregation_bytes(e, n, 64, 4)
                + 2 * aggregation_bytes(e, n, n_class, 4)),
    }
    res = {}
    for name, (model, nbytes) in models.items():
        tr = FullBatchTrainer(model, optax.adam(1e-2), seed=0)
        t0 = time.perf_counter()
        state, hist = tr.fit(g, g.node_feat, g.labels, g.train_mask, epochs=2)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, hist2 = tr.fit(g, g.node_feat, g.labels, g.train_mask,
                              epochs=steps, state=state)
        step_s = (time.perf_counter() - t0) / steps
        losses = [e_.loss for e_ in hist.epochs + hist2.epochs]
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: loss did not fall: {losses}")
        res[name] = {"step_ms": step_s * 1e3, "first_two_steps_s": first_s,
                     "loss_first": losses[0], "loss_last": losses[-1]}
        if jax.devices()[0].platform == "gpu":
            res[name]["aggregation_bound_share"] = bound_share(
                nbytes, step_s, jax.devices()[0].device_kind)
        log(f"[3] {name} train step: " + " ".join(
            f"{k}={v:.4f}" for k, v in res[name].items()))
    return res


# ---------------------------------------------------------------- phase 4
def phase_cli(n_node: int, epochs: int = 2) -> dict:
    """``dgll_tpu.run.main`` in-process: device sampling, then full-graph GCN."""
    base = ["--dataset", "synthetic", "--n_node", str(n_node), "--n_epochs",
            str(epochs), "--n_stops", "0"]
    res = {}
    for name, extra in (("device_sampling", ["--Model", "GraphSAGE",
                                             "--device_sampling"]),
                        ("full_gcn", ["--samp_type", "full", "--Model", "GCN"])):
        out = run.main(base + extra)
        acc = out["trials"][0]["test_acc"]
        if not 0.0 <= acc <= 1.0:
            raise AssertionError(f"CLI {name}: test accuracy {acc}")
        res[name] = acc
        log(f"[4] CLI {name}: test_acc={acc:.4f}")
    return res


# ---------------------------------------------------------------- four cards
def phase_dp_epoch(indptr, src, feats, labels, n_class: int, devices,
                   hidden: int = 256, fanouts=(15, 10), batch: int = 1024,
                   train_frac: float = 0.08) -> dict:
    """DP device-sampling epoch over the mesh (global batch ``batch``)."""
    mesh = make_mesh(("data",), devices=devices)
    n_node = len(indptr) - 1
    train_nodes = np.random.default_rng(0).choice(
        n_node, max(int(train_frac * n_node), batch), replace=False)
    runner = DeviceDPEpochRunner(
        GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0), optax.adam(1e-3),
        DeviceCSR.from_host_arrays(indptr, src), list(fanouts),
        batch // len(devices), train_nodes, mesh, seed=0)
    state = runner.init_state(feats)
    state, warm = jax.block_until_ready(runner.run_epoch(state, feats, labels))
    t0 = time.perf_counter()
    state, loss = jax.block_until_ready(runner.run_epoch(state, feats, labels))
    ms = (time.perf_counter() - t0) / runner.n_batches * 1e3
    warm, loss = float(warm), float(loss)
    peaks = [_peak_bytes(d) for d in devices]
    log(f"[4c] DP x{len(devices)} device-sampling epoch: {ms:.4f} ms/batch, "
        f"loss {warm:.4f} -> {loss:.4f}, peak_bytes_in_use per card {peaks}")
    if not (np.isfinite(loss) and loss < warm):
        raise AssertionError(f"DP epoch: loss did not fall ({warm} -> {loss})")
    # every card holds its replica: nothing ran whole on the first card
    if peaks[0] != "not reported" and min(map(int, peaks)) < 0.25 * max(map(int, peaks)):
        raise AssertionError(f"DP epoch: uneven device memory {peaks}")
    return {"ms_per_batch": ms, "loss": loss, "peak_bytes_in_use": peaks}


def phase_dp_step(indptr, src, feats, labels, n_class: int, devices,
                  hidden: int = 256, fanouts=(15, 10), per_device: int = 256) -> dict:
    """``make_dp_block_step`` on fixed host-sampled blocks against the same
    update computed on one card (mean of the per-sub-batch losses)."""
    D = len(devices)
    hg = HostGraph(indptr, src, len(indptr) - 1)
    sampler = NeighborSampler(list(fanouts), seed=0)
    seeds = np.random.default_rng(3).choice(hg.n_node, D * per_device, replace=False)
    lists = [sampler.sample(hg, seeds[d * per_device:(d + 1) * per_device],
                            pad_to=per_device)[2] for d in range(D)]
    blocks = jax.tree.map(np.asarray, stack_block_lists(lists))
    x = np.asarray(jnp.take(feats, jnp.asarray(blocks[0].src_ids), axis=0))
    y = np.asarray(jnp.take(labels, jnp.asarray(blocks[-1].dst_ids), axis=0))
    m = np.asarray(blocks[-1].dst_mask)
    model = GraphSAGE(hidden=hidden, n_class=n_class, dropout=0.0)
    local = jax.tree.map(lambda a: a[0], blocks)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.key(0), local, x[0])["params"])
    # plain SGD: the update is linear in the gradient, so summation order
    # cannot flip it (adam's first step is ~lr*sign(g))
    tx = optax.sgd(0.1)

    def model_apply(p, blocks, x, rng):
        return model.apply({"params": p}, blocks, x)

    @jax.jit
    def one_card(p, blocks, x, y, m):
        def loss_of(p):
            per = [masked_nll_loss(model_apply(p, jax.tree.map(lambda a: a[d], blocks),
                                               x[d], None), y[d], m[d])
                   for d in range(D)]
            return sum(per) / D

        loss, grads = jax.value_and_grad(loss_of)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    mesh = make_mesh(("data",), devices=devices)
    step = make_dp_block_step(mesh, model_apply, tx)
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_params = one_card(*jax.device_put(
            (params, list(blocks), x, y, m), devices[0]))
        p0 = jax.tree.map(jnp.asarray, params)   # uncommitted: jit places it
        p_dp, _, loss_dp = step(p0, tx.init(p0), list(blocks), x, y, m,
                                jax.random.key(0))
    np.testing.assert_allclose(float(loss_dp), float(ref_loss), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(p_dp), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg="dp params")
    log(f"[4c] make_dp_block_step x{D} vs one card: loss {float(loss_dp):.6f} vs "
        f"{float(ref_loss):.6f}; updated params agree to 1e-4")
    return {"loss_dp": float(loss_dp), "loss_one_card": float(ref_loss)}


def phase_partitioned(g, width: int, devices) -> dict:
    """Halo and all-gather ``make_partitioned_spmm`` against ``spmm_coo`` on
    one card, then one partition-parallel GCN step against its one-card loss."""
    D = len(devices)
    mesh = make_mesh(("data",), devices=devices)
    gh = jax.tree.map(np.asarray, g)
    pg = partition_graph(gh, D, strategy="range")
    pgs = shard_partitioned_graph(pg, mesh)
    perm = np.asarray(pg.perm)
    src = perm[gh.src[: gh.n_real_edge]]
    dst = perm[gh.dst[: gh.n_real_edge]]
    w = gh.edge_weight[: gh.n_real_edge]
    one = jax.jit(lambda x: spmm_coo(src, dst, x, pg.n_node, w))
    x = pgs.node_feat
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(one(jax.device_put(np.asarray(x), devices[0])))
    res = {}
    for strategy in ("halo", "allgather"):
        fn, chosen = make_partitioned_spmm(mesh, pgs, width, strategy=strategy)
        fn = jax.jit(fn)
        out = fn(x)
        if len(out.sharding.device_set) != D:
            raise AssertionError(f"{strategy}: output on {out.sharding.device_set}")
        np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL, atol=ATOL)
        res[strategy] = _timed(lambda: fn(x), 10) * 1e3
        log(f"[4c] partitioned spmm {chosen} x{D}: matches spmm_coo, "
            f"{res[strategy]:.4f} ms")

    rng = np.random.default_rng(0)
    n_class = int(np.asarray(pg.labels).max()) + 1
    params = {"w1": rng.normal(0, 0.1, (width, width)).astype(np.float32),
              "w2": rng.normal(0, 0.1, (width, n_class)).astype(np.float32)}
    tx = optax.adam(1e-2)

    def model_apply(p, spmm, x, rng_):
        return jax.nn.log_softmax(spmm(jax.nn.relu(spmm(x @ p["w1"])) @ p["w2"]))

    step, node_sh, rep = make_gp_gcn_train_step(mesh, pgs, model_apply, tx)
    with jax.default_matmul_precision("highest"):
        ref_loss = masked_nll_loss(
            model_apply(jax.device_put(params, devices[0]), one,
                        jax.device_put(np.asarray(x), devices[0]), None),
            np.asarray(pg.labels), np.asarray(pg.train_mask))
        p_rep = jax.device_put(params, rep)
        _, _, loss = step(p_rep, jax.device_put(tx.init(params), rep), x,
                          pgs.labels, pgs.train_mask, jax.random.key(0))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    log(f"[4c] gp GCN step x{D}: loss {float(loss):.6f} vs one card "
        f"{float(ref_loss):.6f}")
    res["gp_loss"] = float(loss)
    return res


# ------------------------------------------------------------------ driver
def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=[1, 4])
    args = p.parse_args(argv)

    t_start = time.perf_counter()
    devs = phase_device(args.chips)
    cache = count_cache_events()

    products = dict(n_node=2_400_000, avg_deg=25, feat_dim=100, n_class=47)
    indptr, src, feats, labels = products_like(**products)
    log(f"[0] products-shape graph: {len(indptr) - 1} nodes, {len(src)} edges")
    if args.chips == 1:
        phase_minibatch(indptr, src, feats, labels, products["n_class"])
        phase_parity(indptr, src, feats, labels, products["n_class"])
        g = fullgraph_graph(200_000, 16, 128, 128)
        check_spmm(g, 128)
        check_layers(fullgraph_graph(50_000, 16, 128, 128), 128)
        train_steps(g, 128, 128)
        phase_cli(10_000)
    else:
        phase_dp_epoch(indptr, src, feats, labels, products["n_class"], devs[:4])
        phase_dp_step(indptr, src, feats, labels, products["n_class"], devs[:4])
        phase_partitioned(fullgraph_graph(200_000, 16, 128, 128), 128, devs[:4])
    log(f"compile cache: {cache['hits']} hits, {cache['misses']} misses; "
        f"wall {time.perf_counter() - t_start:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
