"""Parallelism over ranks: meshes, collectives, the sharded train step,
tensor parallelism over ``tp`` (``parallel.tensor_parallel``), ring
attention over ``sp``, Switch MoE over ``ep`` and the GPipe/circular
pipeline over ``pp``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over processes, one per
rank; the elastic RPC stack (broker/group/accumulator) is the inter-host
plane around it.  The Sebulba actor/learner split (``split_mesh``,
``check_disjoint``) cuts one mesh into two, and
``collectives.Handoff``/``UnrollHandoff`` carry tensors from one half's
ranks to the other's.  ``parallel.ring_attention`` stays the
module (its functions are not re-exported here, where the JAX package
re-exports them), so ``from moolib_tpu_torch.parallel import
ring_attention`` keeps giving the module it gave before the ring came.
"""

from .mesh import (  # noqa: F401
    AXES,
    NamedSharding,
    PartitionSpec,
    check_disjoint,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    mesh_ranks,
    named,
    parse_mesh_spec,
    replicated,
    shard_batch_spec,
    sharding_of,
    split_mesh,
)
from .collectives import (  # noqa: F401
    Handoff,
    UnrollHandoff,
    all_gather_axis,
    axes_group,
    axis_size,
    broadcast_tree,
    gather_full,
    psum,
    redistribute,
    reduce_scatter_axis,
    ring_permute,
    scatter_shards,
    shard_of,
    tree_pmean,
    tree_psum,
)
from .train import auto_shardings, fsdp_spec, make_train_step, param_shardings  # noqa: F401
from .moe import SwitchMoE, moe_param_spec, moe_shardings, shard_experts  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
