"""Device meshes over ``torch.distributed``: one process per rank.

The JAX package lays a ``jax.sharding.Mesh`` over the devices one process
drives.  The port's counterpart is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, each rank one process (``torchrun``, or the examples' own spawn).
The axis convention is the JAX package's:

- ``dp``: data parallel (batch sharded, grads reduced)
- ``tp``: tensor parallel (weight matrices sharded)
- ``sp``: sequence/context parallel (time axis sharded; ring attention)
- ``ep``: expert parallel (MoE experts sharded)

``dp``, ``tp`` (``parallel.tensor_parallel``), ``sp``
(``parallel.ring_attention``), ``ep`` (``parallel.moe``) and ``pp``
(``parallel.pipeline``) have their meaning in the port.

A :class:`NamedSharding` reads as the JAX package's sharding of the flax
leaf.  Where the port stores a leaf in torch's own layout (ImpalaNet's conv
kernels, ``[out, in, kh, kw]`` against flax's ``[kh, kw, in, out]``), the
sharding carries ``dims``: the tensor dim each spec entry describes.  So
the spec prints, and ``buckets.sharding_signature`` counts, in flax's
order, while the ``DTensor`` placements shard the torch dims.

Call :func:`initialize_distributed` first.  It picks the backend
explicitly: gloo on the CPU and wherever ranks share a card (NCCL refuses
two ranks on one device), NCCL only when every rank of the host has a card
of its own.  ``init_device_mesh("cuda", ...)`` would pick NCCL by itself.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve

AXES = ("dp", "tp", "sp", "ep")


def _unported(what: str, slice_: str):
    raise NotImplementedError(f"{what}: not yet ported (slice {slice_})")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dimension, the
    mesh axis that shards it or ``None``.  Prints as JAX prints it, so a
    sharding signature (``buckets.sharding_signature``) reads the same in
    both packages."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        inner = ", ".join(repr(p) for p in self)
        return f"PartitionSpec({inner}{',' if len(self) == 1 else ''})"

    __str__ = __repr__


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (JAX: ``mesh.shape``).  A
    mapping of axis sizes passes through: a layout can be named without a
    process group."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# The port's 4-D leaves are conv kernels in torch's [out, in, kh, kw]; flax
# holds them as [kh, kw, in, out]: flax dim j is torch dim CONV_FLAX_DIMS[j].
CONV_FLAX_DIMS = (2, 3, 1, 0)


def layout_dims(shape) -> Optional[Tuple[int, ...]]:
    """The tensor dim of each flax dim for a port leaf of ``shape`` stored
    in torch's own layout (a conv kernel), or None where the two agree."""
    return CONV_FLAX_DIMS if len(shape) == 4 else None


def flax_shape(shape) -> Tuple[int, ...]:
    """``shape`` in the flax leaf's order."""
    dims = layout_dims(shape)
    return tuple(shape) if dims is None else tuple(shape[d] for d in dims)


class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a :class:`PartitionSpec`.
    The port's sharded tensors are ``DTensor``s; this object names the
    layout one should have (``param_shardings``, ``redistribute``) and
    answers ``shard_shape`` as the JAX class does.  ``dims`` (None: the
    identity) names the tensor dim each spec entry describes, for a leaf
    the port stores in another order than flax (see the module
    docstring)."""

    __slots__ = ("mesh", "spec", "dims")

    def __init__(self, mesh, spec=PartitionSpec(), dims: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        self.dims = tuple(dims) if dims is not None else None

    def _dim(self, j: int) -> int:
        return j if self.dims is None else self.dims[j]

    def hits(self) -> list:
        """``(axis name, tensor dim)`` for every mesh axis the spec names,
        in spec order (a dim sharded over a tuple of axes gives one pair
        per axis, outermost first)."""
        out = []
        for j, s in enumerate(self.spec):
            for name in (() if s is None else (s if isinstance(s, tuple) else (s,))):
                out.append((name, self._dim(j)))
        return out

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The block shape of a tensor of ``shape`` (the tensor's own
        order)."""
        sizes = axis_sizes(self.mesh)
        out = [int(d) for d in shape]
        for name, d in self.hits():
            out[d] //= sizes[name]
        return tuple(out)

    def spec_order(self, seq: Sequence) -> tuple:
        """A per-tensor-dim sequence in spec (flax) order."""
        return tuple(seq) if self.dims is None else tuple(seq[d] for d in self.dims)

    def placements(self):
        """The ``DTensor`` placements of this sharding, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        where = dict(self.hits())
        return [Shard(where[name]) if name in where else Replicate()
                for name in axis_sizes(self.mesh)]

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec) and self.dims == other.dims)

    def __hash__(self) -> int:
        return hash((id(self.mesh), tuple(self.spec), self.dims))

    def __repr__(self) -> str:
        return f"NamedSharding({axis_sizes(self.mesh)}, {self.spec!r})"


def sharding_of(x) -> Optional[NamedSharding]:
    """The :class:`NamedSharding` of a ``DTensor`` (from its placements), or
    ``None`` for a plain tensor or array (JAX: ``x.sharding``).  A conv
    kernel's spec reads in flax's order (:func:`layout_dims`)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    spec = [None] * x.ndim
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            d = pl.dim % x.ndim
            spec[d] = name if spec[d] is None else (
                (spec[d] if isinstance(spec[d], tuple) else (spec[d],)) + (name,))
    dims = layout_dims(x.shape)
    if dims is not None:
        spec = [spec[d] for d in dims]
    return NamedSharding(mesh, PartitionSpec(*spec), dims)


def choose_backend(device: torch.device, ranks_per_host: int) -> str:
    """gloo on the CPU and when ranks share a card; NCCL only when each rank
    of the host has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if ranks_per_host <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> str:
    """Join this process to the host's process group (JAX:
    ``jax.distributed.initialize``).  Arguments default to the ``torchrun``
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` is ``host:port`` of rank 0's store.  On CUDA
    every rank of a host with fewer cards than ranks binds ``cuda:0``
    (ranks share the card over gloo); otherwise rank r binds card
    ``LOCAL_RANK`` (default r).  Returns the backend chosen."""
    dev = resolve(device)
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend is None:
        backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        # Bind the card before DeviceMesh does: its heuristic would pick
        # LOCAL_RANK, which is no card when ranks share one.
        n = torch.cuda.device_count()
        idx = 0 if local_world > n else int(os.environ.get("LOCAL_RANK", rank)) % n
        torch.cuda.set_device(idx)
        torch.cuda.init()
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return backend


def mesh_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """Resolve an axis-size dict against ``n`` ranks: at most one axis may
    be -1 (it absorbs the rest); with no dict every rank goes to ``dp``.
    The JAX package's rule and messages."""
    if not axes:
        return {"dp": n}
    axes = dict(axes)
    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(v for v in axes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[unknown[0]] = n // known
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    return axes


def make_mesh(axes: Optional[Dict[str, int]] = None,
              ranks: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` from an axis-size dict, e.g. ``{"dp": 4}``, over
    ``ranks`` (default: every rank of the process group).  Every rank of
    the group calls it (sub-groups are created collectively).
    ``device_type`` defaults to CUDA, as every entry point does."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    ranks = list(ranks)
    axes = mesh_axes(axes, len(ranks))
    dtype = device_type or resolve(None).type
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(axes.values()))
    return DeviceMesh(dtype, grid, mesh_dim_names=tuple(axes))


def parse_axes(spec: str) -> Dict[str, int]:
    """``"dp=2,tp=4"`` -> ``{"dp": 2, "tp": 4}`` ('' -> {})."""
    axes: Dict[str, int] = {}
    for part in (spec or "").split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    return axes


def parse_mesh_spec(spec: str, device_type: Optional[str] = None) -> Optional[DeviceMesh]:
    """A mesh from a CLI string like ``"dp=2"`` over the first
    prod(sizes) ranks ('' -> None): the shared parser behind the examples'
    ``--mesh`` flags."""
    if not spec:
        return None
    axes = parse_axes(spec)
    if any(v == -1 for v in axes.values()):
        return make_mesh(axes, device_type=device_type)
    need = math.prod(axes.values())
    return make_mesh(axes, ranks=range(need), device_type=device_type)


def split_mesh(mesh, actor_devices: int):
    """The Sebulba split: its device-to-device trajectory handoff crosses
    processes here, which is a design of its own."""
    _unported("split_mesh (the Sebulba actor/learner split)", "9c")


def check_disjoint(mesh_a, mesh_b, what_a: str = "--mesh", what_b: str = "--actor_mesh"):
    """Companion of :func:`split_mesh`."""
    _unported("check_disjoint (the Sebulba actor/learner split)", "9c")


def named(mesh, *spec) -> NamedSharding:
    """Shorthand: ``named(mesh, "dp", None)`` -> NamedSharding over P(dp, None)."""
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_batch_spec(mesh, time_major: bool = True) -> PartitionSpec:
    """PartitionSpec for an RL batch: batch axis over dp (and time over sp if
    the mesh has one). Time-major [T, B, ...] per the framework convention."""
    sizes = axis_sizes(mesh)
    has_sp = sizes.get("sp", 1) > 1
    if time_major:
        return PartitionSpec("sp" if has_sp else None, "dp")
    return PartitionSpec("dp", "sp" if has_sp else None)


def local_batch_size(mesh, global_batch: int, axis: str = "dp") -> int:
    size = axis_sizes(mesh)[axis]
    if global_batch % size:
        raise ValueError(f"batch {global_batch} not divisible by {axis}={size}")
    return global_batch // size
