from dgll_tpu.parallel.community import (
    community_feature_slice,
    detect_communities,
    load_community_book,
    max_community_size,
    merge_groups,
    permute_graph,
    relabel_communities,
    run_cog,
    save_community_book,
    split_oversized,
)
from dgll_tpu.parallel.dp import (
    ShardedDataLoader,
    make_async_dp_block_step,
    make_dp_block_step,
    stack_block_lists,
)
from dgll_tpu.parallel.halo import (
    HaloPlan,
    allgather_volume_bytes,
    build_halo_plan,
    halo_volume_bytes,
    make_halo_spmm,
    make_partitioned_spmm,
)
from dgll_tpu.parallel.gp import (
    make_gp_gcn_train_step,
    make_sharded_spmm,
    shard_partitioned_graph,
)
from dgll_tpu.parallel.launch import initialize_distributed, is_primary, launch_local
from dgll_tpu.parallel.mesh import make_mesh, replicated, sharded_dim0
from dgll_tpu.parallel.partition import PartitionedGraph, partition_graph
from dgll_tpu.parallel.tp import (
    init_tp_gcn_params,
    make_feature_sharded_spmm,
    make_tp_gcn_apply,
    shard_features,
)

__all__ = [
    "initialize_distributed",
    "is_primary",
    "launch_local",
    "make_feature_sharded_spmm",
    "make_tp_gcn_apply",
    "init_tp_gcn_params",
    "shard_features",
    "run_cog",
    "detect_communities",
    "merge_groups",
    "split_oversized",
    "relabel_communities",
    "permute_graph",
    "max_community_size",
    "save_community_book",
    "load_community_book",
    "community_feature_slice",
    "make_async_dp_block_step",
    "HaloPlan",
    "build_halo_plan",
    "make_halo_spmm",
    "make_partitioned_spmm",
    "halo_volume_bytes",
    "allgather_volume_bytes",
    "make_mesh",
    "replicated",
    "sharded_dim0",
    "PartitionedGraph",
    "partition_graph",
    "shard_partitioned_graph",
    "make_sharded_spmm",
    "make_gp_gcn_train_step",
    "ShardedDataLoader",
    "make_dp_block_step",
    "stack_block_lists",
]
