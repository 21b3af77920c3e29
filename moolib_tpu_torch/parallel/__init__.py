"""Parallelism over ranks: meshes, collectives, the sharded train step, and
the single-device math of ring attention.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over processes, one per
rank; the elastic RPC stack (broker/group/accumulator) is the inter-host
plane around it.  Ring attention over an ``sp`` group, MoE and pipeline
stages come with ROADMAP slice 9b; the Sebulba actor/learner split with
slice 9c.
"""

from .mesh import (  # noqa: F401
    AXES,
    NamedSharding,
    PartitionSpec,
    check_disjoint,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    named,
    parse_mesh_spec,
    replicated,
    shard_batch_spec,
    sharding_of,
    split_mesh,
)
from .collectives import (  # noqa: F401
    all_gather_axis,
    axis_size,
    broadcast_tree,
    gather_full,
    redistribute,
    reduce_scatter_axis,
    ring_permute,
    scatter_shards,
    shard_of,
    tree_pmean,
    tree_psum,
)
from .train import auto_shardings, fsdp_spec, make_train_step, param_shardings  # noqa: F401
