// Native host-side graph kernels for dgll_tpu.
//
// Role parity with the reference's native layer (the CUDA fused kernel +
// pybind11 bridge, /root/reference/dgll/FusedKernel/): here the *device* hot path
// is XLA, and this library covers the *host* hot loops that feed the device —
// CSR construction, fanout neighbour sampling (the minibatch producer), and
// random-walk generation — multithreaded C++ exported with a C ABI and loaded
// via ctypes (no pybind11 dependency).
//
// Build (native.py does this on first use; no -march=native, so a library
// built on one host loads on another):
//   g++ -O3 -shared -fPIC -pthread -o libdgll_host.so graph_kernels.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

// splitmix64 seeded xorshift128+ per worker: fast, reproducible, no libc rand locks
struct Rng {
    uint64_t s0, s1;
    explicit Rng(uint64_t seed) {
        auto sm = [](uint64_t& x) {
            x += 0x9e3779b97f4a7c15ULL;
            uint64_t z = x;
            z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
            z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
            return z ^ (z >> 31);
        };
        uint64_t st = seed;
        s0 = sm(st);
        s1 = sm(st);
        if (!(s0 | s1)) s1 = 1;
    }
    inline uint64_t next() {
        uint64_t a = s0, b = s1;
        s0 = b;
        a ^= a << 23;
        s1 = a ^ b ^ (a >> 18) ^ (b >> 5);
        return s1 + b;
    }
    // unbiased-enough bounded draw (mul-shift)
    inline uint64_t bounded(uint64_t n) {
        return (uint64_t)(((__uint128_t)next() * n) >> 64);
    }
    inline double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

inline int n_workers(int64_t work, int64_t grain) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    int64_t want = work / grain + 1;
    return (int)std::min<int64_t>(hw, std::max<int64_t>(1, want));
}

template <class F>
void parallel_for(int64_t n, int64_t grain, F&& fn) {
    int nw = n_workers(n, grain);
    if (nw <= 1) {
        fn(0, n, 0);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nw - 1) / nw;
    for (int w = 0; w < nw; ++w) {
        int64_t lo = w * chunk, hi = std::min<int64_t>(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back([=, &fn] { fn(lo, hi, w); });
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Counting-sort CSR build. dst[e] in [0, n). Fills indptr[n+1] and order[e]
// (stable permutation that sorts edges by dst — apply to src/weights in python).
// Parallel 3-phase counting sort: per-thread histograms over disjoint edge
// ranges, prefix over (bucket, thread), then an independent stable scatter per
// thread — reference-scale (100M-edge) graphs build in a few seconds.
void dgll_build_csr(const int64_t* dst, int64_t e, int64_t n, int64_t* indptr,
                    int64_t* order) {
    int nw = n_workers(e, 1 << 20);
    if (nw <= 1 || n > (int64_t)1 << 31) {
        std::memset(indptr, 0, sizeof(int64_t) * (n + 1));
        for (int64_t i = 0; i < e; ++i) indptr[dst[i] + 1]++;
        for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
        std::vector<int64_t> cur(indptr, indptr + n);
        for (int64_t i = 0; i < e; ++i) order[cur[dst[i]]++] = i;
        return;
    }
    int64_t chunk = (e + nw - 1) / nw;
    std::vector<std::vector<int64_t>> local(nw);
    {
        std::vector<std::thread> ts;
        for (int w = 0; w < nw; ++w)
            ts.emplace_back([&, w] {
                auto& h = local[w];
                h.assign(n, 0);
                int64_t lo = w * chunk, hi = std::min(e, lo + chunk);
                for (int64_t i = lo; i < hi; ++i) h[dst[i]]++;
            });
        for (auto& t : ts) t.join();
    }
    // indptr + per-thread start offsets: thread w's slot run for bucket v begins at
    // indptr[v] + sum_{u<w} local[u][v] (stable: earlier threads take earlier slots)
    indptr[0] = 0;
    for (int64_t v = 0; v < n; ++v) {
        int64_t tot = 0;
        for (int w = 0; w < nw; ++w) {
            int64_t c = local[w][v];
            local[w][v] = tot;  // becomes the within-bucket offset for thread w
            tot += c;
        }
        indptr[v + 1] = indptr[v] + tot;
    }
    {
        std::vector<std::thread> ts;
        for (int w = 0; w < nw; ++w)
            ts.emplace_back([&, w] {
                auto& off = local[w];
                int64_t lo = w * chunk, hi = std::min(e, lo + chunk);
                for (int64_t i = lo; i < hi; ++i) {
                    int64_t v = dst[i];
                    order[indptr[v] + off[v]++] = i;
                }
            });
        for (auto& t : ts) t.join();
    }
}

// Uniform with-replacement fanout sampling over an in-edge CSR.
// nodes[b] (global ids), mask[b]; writes out[b*k] sampled neighbour ids and
// outmask[b*k]. Zero-degree / masked rows emit the node's own id with mask 0.
void dgll_sample_neighbors(const int64_t* indptr, const int64_t* nbrs,
                           const int64_t* nodes, const uint8_t* mask, int64_t b,
                           int64_t k, uint64_t seed, int64_t* out,
                           uint8_t* outmask) {
    parallel_for(b, 4096, [&](int64_t lo, int64_t hi, int w) {
        Rng rng(seed * 0x100000001b3ULL + (uint64_t)w * 0x9e3779b9ULL + lo);
        for (int64_t i = lo; i < hi; ++i) {
            int64_t v = nodes[i];
            int64_t d0 = indptr[v], d1 = indptr[v + 1];
            int64_t deg = d1 - d0;
            bool ok = mask[i] && deg > 0;
            for (int64_t j = 0; j < k; ++j) {
                int64_t slot = i * k + j;
                if (ok) {
                    out[slot] = nbrs[d0 + (int64_t)rng.bounded((uint64_t)deg)];
                    outmask[slot] = 1;
                } else {
                    out[slot] = v;
                    outmask[slot] = 0;
                }
            }
        }
    });
}

// Uniform random walks over an out-edge CSR: walks[nw, L], starts[nw].
// Zero-degree nodes self-loop (fixed-length walks for static shapes downstream).
void dgll_random_walks(const int64_t* indptr, const int64_t* nbrs,
                       const int64_t* starts, int64_t nw, int64_t L, uint64_t seed,
                       int64_t* walks) {
    parallel_for(nw, 1024, [&](int64_t lo, int64_t hi, int w) {
        Rng rng(seed * 0x100000001b3ULL + (uint64_t)w * 0x9e3779b9ULL + lo);
        for (int64_t i = lo; i < hi; ++i) {
            int64_t cur = starts[i];
            walks[i * L] = cur;
            for (int64_t t = 1; t < L; ++t) {
                int64_t d0 = indptr[cur], deg = indptr[cur + 1] - d0;
                if (deg > 0) cur = nbrs[d0 + (int64_t)rng.bounded((uint64_t)deg)];
                walks[i * L + t] = cur;
            }
        }
    });
}

// node2vec p/q-biased 2nd-order walks via rejection sampling over a *sorted*
// out-edge CSR (sorted rows give O(log d) membership tests).
void dgll_node2vec_walks(const int64_t* indptr, const int64_t* nbrs_sorted,
                         const int64_t* starts, int64_t nw, int64_t L, double p,
                         double q, uint64_t seed, int64_t* walks) {
    const double inv_p = 1.0 / p, inv_q = 1.0 / q;
    const double wmax = std::max(1.0, std::max(inv_p, inv_q));
    parallel_for(nw, 512, [&](int64_t lo, int64_t hi, int w) {
        Rng rng(seed * 0x100000001b3ULL + (uint64_t)w * 0x9e3779b9ULL + lo);
        auto has_edge = [&](int64_t u, int64_t v) {
            const int64_t* b = nbrs_sorted + indptr[u];
            const int64_t* e = nbrs_sorted + indptr[u + 1];
            const int64_t* it = std::lower_bound(b, e, v);
            return it != e && *it == v;
        };
        for (int64_t i = lo; i < hi; ++i) {
            int64_t cur = starts[i], prev = cur;
            walks[i * L] = cur;
            for (int64_t t = 1; t < L; ++t) {
                int64_t d0 = indptr[cur], deg = indptr[cur + 1] - d0;
                if (deg == 0) {
                    walks[i * L + t] = cur;
                    prev = cur;
                    continue;
                }
                int64_t cand = cur;
                for (int r = 0; r < 16; ++r) {
                    cand = nbrs_sorted[d0 + (int64_t)rng.bounded((uint64_t)deg)];
                    double wgt = (cand == prev) ? inv_p
                                 : (has_edge(prev, cand) ? 1.0 : inv_q);
                    if (rng.uniform() < wgt / wmax) break;
                }
                prev = cur;
                cur = cand;
                walks[i * L + t] = cur;
            }
        }
    });
}

// Parallel id remap: out[i] = map[idx[i]] (the relabeling gathers dominate
// partition/COG at 100M edges on few-core hosts; numpy does them single-threaded).
void dgll_remap(const int64_t* map, const int64_t* idx, int64_t e, int64_t* out) {
    parallel_for(e, 1 << 21, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) out[i] = map[idx[i]];
    });
}

// Fused CSR build + permutation apply: like dgll_build_csr, but the scatter pass
// writes the permuted src/dst/weight directly (int32 outputs), skipping the
// numpy fancy-gather passes that dominate at 100M edges on few-core hosts.
void dgll_build_csr_apply(const int64_t* dst, const int64_t* src, const float* w,
                          int64_t e, int64_t n, int64_t* indptr, int32_t* src_out,
                          int32_t* dst_out, float* w_out) {
    int nw = n_workers(e, 1 << 20);
    // each worker allocates an n-sized int64 histogram: cap the total at ~256 MB
    // (mirrors dgll_build_csr's large-n serial guard) so huge-n graphs on
    // many-core hosts don't transiently blow up memory
    while (nw > 1 && (int64_t)nw * n * (int64_t)sizeof(int64_t) > ((int64_t)1 << 28))
        --nw;
    if (nw <= 1) {
        std::memset(indptr, 0, sizeof(int64_t) * (n + 1));
        for (int64_t i = 0; i < e; ++i) indptr[dst[i] + 1]++;
        for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
        std::vector<int64_t> cur(indptr, indptr + n);
        for (int64_t i = 0; i < e; ++i) {
            int64_t v = dst[i];
            int64_t slot = cur[v]++;
            src_out[slot] = (int32_t)src[i];
            dst_out[slot] = (int32_t)v;
            if (w_out) w_out[slot] = w[i];
        }
        return;
    }
    int64_t chunk = (e + nw - 1) / nw;
    std::vector<std::vector<int64_t>> local(nw);
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < nw; ++t)
            ts.emplace_back([&, t] {
                auto& h = local[t];
                h.assign(n, 0);
                int64_t lo = t * chunk, hi = std::min(e, lo + chunk);
                for (int64_t i = lo; i < hi; ++i) h[dst[i]]++;
            });
        for (auto& t : ts) t.join();
    }
    indptr[0] = 0;
    for (int64_t v = 0; v < n; ++v) {
        int64_t tot = 0;
        for (int t = 0; t < nw; ++t) {
            int64_t c = local[t][v];
            local[t][v] = tot;
            tot += c;
        }
        indptr[v + 1] = indptr[v] + tot;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < nw; ++t)
        ts.emplace_back([&, t] {
            auto& off = local[t];
            int64_t lo = t * chunk, hi = std::min(e, lo + chunk);
            for (int64_t i = lo; i < hi; ++i) {
                int64_t v = dst[i];
                int64_t slot = indptr[v] + off[v]++;
                src_out[slot] = (int32_t)src[i];
                dst_out[slot] = (int32_t)v;
                if (w_out) w_out[slot] = w[i];
            }
        });
    for (auto& t : ts) t.join();
}

// Pack relabeled edges into per-shard padded slabs (partition_graph's hot loop):
// shard p owns dst rows [p*rows, (p+1)*rows); edge i lands at slot
// (p, within-shard arrival index). Stable parallel two-phase counting scatter.
void dgll_partition_pack(const int64_t* src, const int64_t* dst, const float* w,
                         int64_t e, int64_t rows, int64_t n_parts, int64_t e_shard,
                         int32_t* S, int32_t* D, float* W) {
    int nw = n_workers(e, 1 << 20);
    int64_t chunk = (e + nw - 1) / nw;
    std::vector<std::vector<int64_t>> local(nw);
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < nw; ++t)
            ts.emplace_back([&, t] {
                auto& h = local[t];
                h.assign(n_parts, 0);
                int64_t lo = t * chunk, hi = std::min(e, lo + chunk);
                for (int64_t i = lo; i < hi; ++i) h[dst[i] / rows]++;
            });
        for (auto& t : ts) t.join();
    }
    for (int64_t p = 0; p < n_parts; ++p) {
        int64_t tot = 0;
        for (int t = 0; t < nw; ++t) {
            int64_t c = local[t][p];
            local[t][p] = tot;
            tot += c;
        }
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < nw; ++t)
        ts.emplace_back([&, t] {
            auto off = local[t];
            int64_t lo = t * chunk, hi = std::min(e, lo + chunk);
            for (int64_t i = lo; i < hi; ++i) {
                int64_t p = dst[i] / rows;
                int64_t slot = p * e_shard + off[p]++;
                S[slot] = (int32_t)src[i];
                D[slot] = (int32_t)(dst[i] - p * rows);
                W[slot] = w[i];
            }
        });
    for (auto& t : ts) t.join();
}

// Asynchronous label propagation over the in-edge CSR — the COG community
// detector's hot loop (reference runs igraph/leidenalg here, cog.py:218-228).
// In-place on labels[n]; returns after max_iters or convergence. Races between
// worker threads are benign for LP (async update is the classic formulation).
void dgll_label_propagation(const int64_t* indptr, const int64_t* nbrs, int64_t n,
                            int64_t max_iters, int64_t* labels) {
    for (int64_t it = 0; it < max_iters; ++it) {
        std::atomic<int64_t> changed{0};
        parallel_for(n, 16384, [&](int64_t lo, int64_t hi, int) {
            // grow-only open-addressing counter, reset via touched list
            std::vector<int64_t> key;
            std::vector<int32_t> cnt;
            std::vector<int64_t> touched;
            size_t cap = 0;
            for (int64_t v = lo; v < hi; ++v) {
                int64_t d0 = indptr[v], deg = indptr[v + 1] - d0;
                if (deg == 0) continue;
                size_t want = 1;
                while (want < (size_t)deg * 2) want <<= 1;
                if (want > cap) {
                    cap = want;
                    key.assign(cap, -1);
                    cnt.assign(cap, 0);
                } else {
                    for (int64_t t : touched) key[t] = -1, cnt[t] = 0;
                }
                touched.clear();
                int64_t cur = labels[v];
                int64_t best = cur;
                int32_t best_cnt = 0, cur_cnt = 0;
                for (int64_t e = d0; e < d0 + deg; ++e) {
                    int64_t l = labels[nbrs[e]];
                    size_t h = (size_t)(l * 0x9e3779b97f4a7c15ULL) & (cap - 1);
                    while (key[h] != -1 && key[h] != l) h = (h + 1) & (cap - 1);
                    if (key[h] == -1) {
                        key[h] = l;
                        touched.push_back((int64_t)h);
                    }
                    int32_t c = ++cnt[h];
                    if (l == cur) cur_cnt = c;
                    if (c > best_cnt || (c == best_cnt && l < best)) {
                        best_cnt = c;
                        best = l;
                    }
                }
                // strict-majority moves always; ties move only toward the smaller
                // label — monotone, so async sweeps converge (no oscillation)
                if (best_cnt > cur_cnt || (best_cnt == cur_cnt && best < cur)) {
                    labels[v] = best;
                    changed.fetch_add(1, std::memory_order_relaxed);
                }
            }
        });
        if (changed.load() == 0) break;
    }
}

// Sort each CSR row in place (WalkGraph prep: sorted rows give O(log d)
// membership tests for node2vec rejection sampling).
void dgll_sort_rows(const int64_t* indptr, int64_t n, int64_t* vals) {
    parallel_for(n, 4096, [&](int64_t lo, int64_t hi, int) {
        for (int64_t v = lo; v < hi; ++v)
            std::sort(vals + indptr[v], vals + indptr[v + 1]);
    });
}

// Fused multi-layer block sampling — ONE call builds a whole minibatch.
//
// The per-batch host path used to be L sample calls + numpy concat/astype
// passes per layer (the cost the reference pays per batch too,
// base_sampler.py:30-58 + dgllsampler.py:14-19); at products scale that keeps
// a 2-core host from feeding the device. Here the frontier is ONE growing int32
// buffer: frontier_k = ids[0:n_k], layer k's samples land at
// ids[n_k : n_k*(1+f_k)], so every Block is a zero-copy view.
//
// ids/mask must be preallocated with n_final entries and ids[0:b]/mask[0:b]
// prefilled with the (padded) seeds. Nodes outside [lo, hi) alias their
// destination with mask 0 (community-restricted sampling; pass 0/INT64_MAX
// for unrestricted). fanouts[k] is applied in the given order (callers pass
// reversed(fanouts), matching NeighborSampler's innermost-first growth).
void dgll_sample_block_fused(const int64_t* indptr, const int64_t* nbrs,
                             const int64_t* fanouts, int64_t n_layers, int64_t b,
                             int64_t lo_id, int64_t hi_id, uint64_t seed,
                             int32_t* ids, uint8_t* mask) {
    int64_t n = b;
    for (int64_t k = 0; k < n_layers; ++k) {
        const int64_t f = fanouts[k];
        parallel_for(n, 2048, [&](int64_t lo, int64_t hi, int w) {
            (void)w;
            for (int64_t i = lo; i < hi; ++i) {
                // Seed per ROW from machine-independent state only (user seed,
                // layer, row index) — never from worker ids or chunk bounds,
                // which derive from hardware_concurrency(): the same seed must
                // reproduce the same sample on any core count (and match the
                // single-thread path). Rng init is two splitmix64 rounds, noise
                // next to the fanout loop's gather work.
                // 0x85ebca6b9 is intentional (odd 36-bit multiplier, not
                // murmur3's 0x85ebca6b): recorded artifacts/tests depend on
                // this stream, so it must not change.
                Rng rng(seed * 0x100000001b3ULL + (uint64_t)k * 0x9e3779b9ULL +
                        (uint64_t)i * 0x85ebca6b9ULL);
                const int64_t v = ids[i];
                const int64_t d0 = indptr[v], deg = indptr[v + 1] - d0;
                const bool ok = mask[i] && deg > 0;
                int32_t* out = ids + n + i * f;
                uint8_t* om = mask + n + i * f;
                for (int64_t j = 0; j < f; ++j) {
                    if (ok) {
                        int64_t u = nbrs[d0 + (int64_t)rng.bounded((uint64_t)deg)];
                        if (u >= lo_id && u < hi_id) {
                            out[j] = (int32_t)u;
                            om[j] = 1;
                            continue;
                        }
                    }
                    out[j] = (int32_t)v;
                    om[j] = 0;
                }
            }
        });
        n += n * f;
    }
}

int dgll_abi_version() { return 3; }

}  // extern "C"
