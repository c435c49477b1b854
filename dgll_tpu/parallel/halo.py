"""Halo-exchange partitioned SpMM: boundary features move via one all_to_all.

The v2 of ``parallel/gp.py``'s all_gather strategy and the structural centerpiece of
the multi-host design (SURVEY.md §2.7 / §5): each shard owns a contiguous
destination-row range; the *halo plan* precomputes, per (requester p, owner q) pair,
the unique boundary rows p needs from q, padded to one static size H. Each step then
does ONE static ``all_to_all`` of shape [D, H, F] — message volume proportional to the
partition cut (vs all_gather's full feature matrix), and XLA overlaps it with the
local gather. This replaces the reference's shared-memory graph store + remote fetch
(``FeatureCache/gcn.py:30``, ``storage.py:151-198``) with a compiled collective.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dgll_tpu.parallel.partition import PartitionedGraph
from dgll_tpu.utils import struct


@struct.dataclass
class HaloPlan:
    send_ids: jax.Array    # [D, D, H] int32 — send_ids[q, p] = local rows q sends to p
    send_mask: jax.Array   # [D, D, H] bool
    src_remap: jax.Array   # [D, e_shard] int32 into [local rows | D*H halo rows]
    halo_size: int = struct.field(pytree_node=False, default=0)


def build_halo_plan(pg: PartitionedGraph, halo_multiple: int = 8) -> HaloPlan:
    """Host-side halo planning from the partitioned edge lists.

    Fully vectorised (no per-edge Python): per requester p, remote needs are the
    unique off-shard sources; slot assignment goes through an O(n_node) id->slot
    table instead of a dict, so planning a 100M-edge graph takes seconds.
    """
    D, rows = pg.n_shard, pg.rows_per_shard
    src = np.asarray(pg.src).astype(np.int64)   # [D, e_shard] global ids
    w = np.asarray(pg.edge_weight)
    n_node = D * rows

    # per requester p: sorted unique remote sources, already grouped by owner
    # (ids are contiguous per owner, so unique() output is owner-sorted for free)
    needs = []
    H = 1
    for p in range(D):
        sp = src[p]
        need = np.unique(sp[(sp // rows != p) & (w[p] != 0)])
        needs.append(need)
        if len(need):
            H = max(H, int(np.bincount(need // rows, minlength=D).max()))
    H = ((H + halo_multiple - 1) // halo_multiple) * halo_multiple

    send_ids = np.zeros((D, D, H), np.int32)     # [owner q, requester p]
    send_mask = np.zeros((D, D, H), bool)
    slot_of = np.zeros(n_node, np.int64)         # per-p id -> halo slot (reused)
    src_remap = np.zeros((D, src.shape[1]), np.int32)
    for p in range(D):
        need = needs[p]
        owner = need // rows
        # rank within owner group (need is sorted, so groups are runs)
        starts = np.searchsorted(owner, np.arange(D))
        within = np.arange(len(need), dtype=np.int64) - starts[owner]
        send_ids[owner, p, within] = (need - owner * rows).astype(np.int32)
        send_mask[owner, p, within] = True
        slot_of[need] = owner * H + within
        sp = src[p]
        local = (sp // rows) == p
        src_remap[p] = np.where(local, sp - p * rows, rows + slot_of[sp])
        slot_of[need] = 0  # reset touched entries for the next requester
    return HaloPlan(
        send_ids=jnp.asarray(send_ids),
        send_mask=jnp.asarray(send_mask),
        src_remap=jnp.asarray(src_remap),
        halo_size=H,
    )


def make_halo_spmm(mesh: Mesh, pg: PartitionedGraph, plan: HaloPlan,
                   axis: str = "data"):
    """Sharded out[i] = sum w_e x[src_e] with halo all_to_all feature exchange."""
    rows = pg.rows_per_shard

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None), P(axis, None, None),
                  P(axis, None), P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    def spmm(x_local, send_ids, send_mask, src_remap, dst_local, w):
        send_ids, send_mask = send_ids[0], send_mask[0]        # [D, H]
        src_remap, dst_local, w = src_remap[0], dst_local[0], w[0]
        # rows this shard owes each peer
        out_rows = jnp.take(x_local, send_ids, axis=0)          # [D, H, F]
        out_rows = out_rows * send_mask[..., None].astype(out_rows.dtype)
        halo = jax.lax.all_to_all(out_rows, axis, split_axis=0, concat_axis=0,
                                  tiled=False)                  # [D, H, F]
        ext = jnp.concatenate([x_local, halo.reshape(-1, x_local.shape[-1])], axis=0)
        msg = jnp.take(ext, src_remap, axis=0) * w[:, None].astype(x_local.dtype)
        return jax.ops.segment_sum(msg, dst_local, num_segments=rows)

    def apply(x):
        return spmm(x, plan.send_ids, plan.send_mask, plan.src_remap,
                    pg.dst_local, pg.edge_weight)

    return apply


def halo_volume_bytes(pg: PartitionedGraph, plan: HaloPlan, feat_dim: int,
                      itemsize: int = 4) -> int:
    """all_to_all bytes per step (whole mesh)."""
    return pg.n_shard * pg.n_shard * plan.halo_size * feat_dim * itemsize


def allgather_volume_bytes(pg: PartitionedGraph, feat_dim: int, itemsize: int = 4) -> int:
    """all_gather bytes per step (whole mesh)."""
    return pg.n_shard * (pg.n_shard - 1) * pg.rows_per_shard * feat_dim * itemsize


def make_partitioned_spmm(mesh: Mesh, pg: PartitionedGraph, feat_dim: int,
                          strategy: str = "auto", axis: str = "data"):
    """Pick the cheaper exchange automatically: halo all_to_all when the partition
    cut is small (clustered graphs), all_gather when boundary padding would exceed
    the full matrix (hub-heavy graphs with poor cuts).

    Returns ``(spmm_fn, chosen_strategy)`` where ``chosen_strategy`` is
    ``"halo"`` or ``"allgather"``."""
    from dgll_tpu.parallel.gp import make_sharded_spmm

    if strategy == "allgather":
        return make_sharded_spmm(mesh, pg, axis), "allgather"
    plan = build_halo_plan(pg)
    if strategy == "halo":
        return make_halo_spmm(mesh, pg, plan, axis), "halo"
    if halo_volume_bytes(pg, plan, feat_dim) < allgather_volume_bytes(pg, feat_dim):
        return make_halo_spmm(mesh, pg, plan, axis), "halo"
    return make_sharded_spmm(mesh, pg, axis), "allgather"
