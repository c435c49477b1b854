"""ctypes loader for the native host kernels (``dgll_tpu/csrc/graph_kernels.cpp``).

Compiles the shared library on first use (g++, cached next to the source) and exposes
numpy-friendly wrappers. Every entry point has a pure-numpy fallback, so the package
works without a toolchain; ``native_available()`` reports which path is active.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRC = os.path.join(_DIR, "graph_kernels.cpp")
_SO = os.path.join(_DIR, "libdgll_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    # build under a per-process name, then rename into place: processes that
    # start together (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        # check the ABI before binding symbols: a stale libdgll_host.so (e.g.
        # copied in with a fresh mtime) must fall back to numpy, not raise
        try:
            lib.dgll_abi_version.restype = ctypes.c_int
            if lib.dgll_abi_version() != 3:
                return None
        except (OSError, AttributeError):
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dgll_build_csr.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
        lib.dgll_sample_neighbors.argtypes = [
            i64p, i64p, i64p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, i64p, u8p,
        ]
        lib.dgll_random_walks.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i64p,
        ]
        lib.dgll_node2vec_walks.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64, i64p,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.dgll_remap.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
        lib.dgll_build_csr_apply.argtypes = [
            i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p, f32p,
        ]
        lib.dgll_partition_pack.argtypes = [
            i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i32p, i32p, f32p,
        ]
        lib.dgll_label_propagation.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
        ]
        lib.dgll_sort_rows.argtypes = [i64p, ctypes.c_int64, i64p]
        lib.dgll_sample_block_fused.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i32p, u8p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pu8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def build_csr(dst: np.ndarray, n_node: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr [n+1], order [e]) — stable sort permutation of edges by dst."""
    dst = np.ascontiguousarray(dst, np.int64)
    e = len(dst)
    lib = get_lib()
    if lib is None:
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(n_node + 1, np.int64)
        np.add.at(indptr, dst + 1, 1)
        return np.cumsum(indptr), order
    indptr = np.empty(n_node + 1, np.int64)
    order = np.empty(e, np.int64)
    lib.dgll_build_csr(_p64(dst), e, n_node, _p64(indptr), _p64(order))
    return indptr, order


def sample_neighbors(
    indptr: np.ndarray, nbrs: np.ndarray, nodes: np.ndarray, mask: np.ndarray,
    fanout: int, seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """[b, fanout] with-replacement neighbour sample + validity mask."""
    lib = get_lib()
    b = len(nodes)
    if lib is None:
        return _np_sample(indptr, nbrs, nodes, mask, fanout, seed)
    nodes = np.ascontiguousarray(nodes, np.int64)
    mask8 = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(b * fanout, np.int64)
    om = np.empty(b * fanout, np.uint8)
    lib.dgll_sample_neighbors(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(nodes), _pu8(mask8), b, fanout, seed & 0xFFFFFFFFFFFFFFFF,
        _p64(out), _pu8(om),
    )
    return out.reshape(b, fanout), om.reshape(b, fanout).astype(bool)


def _np_sample(indptr, nbrs, nodes, mask, fanout, seed):
    rng = np.random.default_rng(seed)
    nodes = np.asarray(nodes, np.int64)
    deg = indptr[nodes + 1] - indptr[nodes]
    start = indptr[nodes]
    valid = (deg > 0) & np.asarray(mask, bool)
    off = (rng.random((len(nodes), fanout)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
    idx = np.minimum(start[:, None] + off, max(len(nbrs) - 1, 0))
    sampled = nbrs[idx] if len(nbrs) else np.zeros_like(idx)
    m = np.broadcast_to(valid[:, None], (len(nodes), fanout))
    return np.where(m, sampled, nodes[:, None]), m.copy()


def random_walks(indptr, nbrs, starts, walk_length: int, seed: int) -> np.ndarray:
    lib = get_lib()
    starts = np.ascontiguousarray(starts, np.int64)
    nw = len(starts)
    if lib is None:
        return _np_walks(indptr, nbrs, starts, walk_length, seed)
    walks = np.empty(nw * walk_length, np.int64)
    lib.dgll_random_walks(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(starts), nw, walk_length, seed & 0xFFFFFFFFFFFFFFFF, _p64(walks),
    )
    return walks.reshape(nw, walk_length)


def _np_walks(indptr, nbrs, starts, L, seed):
    rng = np.random.default_rng(seed)
    cur = starts.copy()
    walks = np.empty((len(cur), L), np.int64)
    walks[:, 0] = cur
    for t in range(1, L):
        deg = indptr[cur + 1] - indptr[cur]
        off = (rng.random(len(cur)) * np.maximum(deg, 1)).astype(np.int64)
        nxt = nbrs[np.minimum(indptr[cur] + off, max(len(nbrs) - 1, 0))] if len(nbrs) else cur
        cur = np.where(deg > 0, nxt, cur)
        walks[:, t] = cur
    return walks


def sample_block_fused(
    indptr: np.ndarray,
    nbrs: np.ndarray,
    seeds: np.ndarray,
    seed_mask: np.ndarray,
    fanouts_innermost_first,
    seed: int,
    lo: int = 0,
    hi: Optional[int] = None,
    out_ids: Optional[np.ndarray] = None,
    out_mask: Optional[np.ndarray] = None,
):
    """One C++ call samples every layer of a minibatch (frontier-growth layout).

    ``fanouts_innermost_first`` is the order the frontier grows in — i.e.
    ``reversed(model_fanouts)``. Returns ``(ids int32 [n_final], mask uint8
    [n_final], sizes)`` where ``sizes[k]`` is the frontier length after k
    layers (``sizes[0] == len(seeds)``); layer k's Block views are slices of
    ``ids``/``mask``. ``out_ids``/``out_mask`` allow buffer reuse across
    batches. Returns None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    b = len(seeds)
    fo = np.ascontiguousarray(list(fanouts_innermost_first), np.int64)
    sizes = [b]
    for f in fo:
        sizes.append(sizes[-1] * (1 + int(f)))
    n_final = sizes[-1]
    ids = out_ids if out_ids is not None and len(out_ids) >= n_final else np.empty(n_final, np.int32)
    mask = out_mask if out_mask is not None and len(out_mask) >= n_final else np.empty(n_final, np.uint8)
    ids[:b] = seeds
    mask[:b] = seed_mask
    lib.dgll_sample_block_fused(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(fo), len(fo), b,
        int(lo), int(np.iinfo(np.int64).max if hi is None else hi),
        seed & 0xFFFFFFFFFFFFFFFF,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _pu8(mask),
    )
    # Slice (zero-copy views) so buffer reuse with an oversized out buffer can
    # never change the returned shape — blocks_from_packed infers the batch
    # size from ids.shape[0] // total_grow and would silently misalign blocks.
    return ids[:n_final], mask[:n_final], sizes


def remap(mapping: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = mapping[idx[i]], multithreaded (falls back to numpy fancy indexing)."""
    lib = get_lib()
    if lib is None:
        return np.asarray(mapping, np.int64)[np.asarray(idx, np.int64)]
    mapping = np.ascontiguousarray(mapping, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty(len(idx), np.int64)
    lib.dgll_remap(_p64(mapping), _p64(idx), len(idx), _p64(out))
    return out


def build_csr_apply(dst, src, w, n_node: int):
    """Fused CSR build + permutation: returns (indptr int64, src int32, dst int32,
    w float32 | None) sorted by dst. None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dst = np.ascontiguousarray(dst, np.int64)
    src = np.ascontiguousarray(src, np.int64)
    e = len(dst)
    indptr = np.empty(n_node + 1, np.int64)
    src_out = np.empty(e, np.int32)
    dst_out = np.empty(e, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    if w is not None:
        w = np.ascontiguousarray(w, np.float32)
        w_out = np.empty(e, np.float32)
        wp, wop = w.ctypes.data_as(fp), w_out.ctypes.data_as(fp)
    else:
        w_out = None
        wp, wop = ctypes.cast(None, fp), ctypes.cast(None, fp)
    lib.dgll_build_csr_apply(
        _p64(dst), _p64(src), wp, e, n_node, _p64(indptr),
        src_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), wop,
    )
    return indptr, src_out, dst_out, w_out


def partition_pack(src, dst, w, rows: int, n_parts: int, e_shard: int):
    """Scatter relabeled edges into per-shard padded slabs; returns (S, D, W)
    of shape [n_parts, e_shard] (int32/int32/float32). None if lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    S = np.zeros((n_parts, e_shard), np.int32)
    D = np.zeros((n_parts, e_shard), np.int32)
    W = np.zeros((n_parts, e_shard), np.float32)
    lib.dgll_partition_pack(
        _p64(src), _p64(dst),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(src), rows, n_parts, e_shard,
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        D.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        W.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return S, D, W


def label_propagation_native(indptr, nbrs, n: int, max_iters: int,
                             labels: np.ndarray) -> bool:
    """In-place async label propagation; returns False if the library is missing."""
    lib = get_lib()
    if lib is None:
        return False
    assert labels.dtype == np.int64 and labels.flags["C_CONTIGUOUS"]
    lib.dgll_label_propagation(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        n, max_iters, _p64(labels),
    )
    return True


def sort_rows(indptr: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Sort each CSR row of ``vals`` (returns a sorted copy)."""
    vals = np.ascontiguousarray(vals, np.int64).copy()
    lib = get_lib()
    n = len(indptr) - 1
    if lib is None:
        for v in range(n):
            lo, hi = indptr[v], indptr[v + 1]
            vals[lo:hi] = np.sort(vals[lo:hi])
        return vals
    lib.dgll_sort_rows(_p64(np.ascontiguousarray(indptr, np.int64)), n, _p64(vals))
    return vals


def node2vec_walks_native(indptr, nbrs_sorted, starts, walk_length: int, p: float,
                          q: float, seed: int) -> Optional[np.ndarray]:
    """Biased walks; returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    nw = len(starts)
    walks = np.empty(nw * walk_length, np.int64)
    lib.dgll_node2vec_walks(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs_sorted, np.int64)),
        _p64(starts), nw, walk_length, p, q, seed & 0xFFFFFFFFFFFFFFFF, _p64(walks),
    )
    return walks.reshape(nw, walk_length)
