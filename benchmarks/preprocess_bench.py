"""Host preprocessing at reference scale: partition + halo plan + COG on a
100M-edge synthetic power-law graph (VERDICT r1 #5 target: < 60 s total).

Host-only work: run with JAX_PLATFORMS=cpu.
Env knobs: PB_NODES (default 5M), PB_DEG (default 20), PB_PARTS (default 8).
Prints one JSON line with per-phase seconds.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from dgll_tpu.graph import Graph
    from dgll_tpu.parallel import build_halo_plan, partition_graph, run_cog

    n_node = int(os.environ.get("PB_NODES", 5_000_000))
    avg_deg = int(os.environ.get("PB_DEG", 20))
    n_parts = int(os.environ.get("PB_PARTS", 8))

    rng = np.random.default_rng(0)
    n_edge = n_node * avg_deg
    w = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-0.8)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    t0 = time.perf_counter()
    dst = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
    src = rng.integers(0, n_node, n_edge)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    g = Graph.from_edges(src, dst, n_node)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pg = partition_graph(g, n_parts)
    part_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    plan = build_halo_plan(pg)
    halo_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, book, cog_t = run_cog(g, hbm_budget_bytes=1 << 32, batch_size=4096, seed=0)
    cog_s = time.perf_counter() - t0

    total = part_s + halo_s + cog_s
    print(json.dumps({
        "metric": "preprocess_100M_edges",
        "value": round(total, 2),
        "unit": "s",
        "detail": {
            "n_node": n_node, "n_edge": n_edge, "n_parts": n_parts,
            "graph_gen_s": round(gen_s, 2), "csr_build_s": round(build_s, 2),
            "partition_s": round(part_s, 2), "halo_plan_s": round(halo_s, 2),
            "cog_s": round(cog_s, 2), "cog_phases": {k: round(v, 2) for k, v in cog_t.items()},
            "n_communities": len(book), "halo_size": plan.halo_size,
            "target_s": 60,
        },
    }))


if __name__ == "__main__":
    main()
