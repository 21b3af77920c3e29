"""Collectives over a named mesh dimension's process group.

The JAX package's helpers run inside ``shard_map`` and name an axis; XLA
lowers them to ICI collectives.  Here each rank is a process, so every
helper takes the ``DeviceMesh`` and the axis name and calls
``torch.distributed`` on that dimension's group.  Every rank of the group
calls the same helpers in the same order.

JAX's ``shard_map`` shim has no torch meaning: the code between collectives
already runs per rank.  JAX's ``pcast`` has none either: torch has no
varying-axes types to cast between.

Host staging: gloo reduces host memory.  Where the group's backend is gloo
and a tensor lies on the card (ranks sharing one card), the helper copies
it into pinned host memory, runs the collective there and copies the
result back, counting the bytes in
``collectives_host_staged_bytes_total``.  The choice is made from the
backend and the device before the call; no error is caught and retried
another way.  NCCL groups take CUDA tensors as they are.

:func:`redistribute` is the counterpart of ``jax.device_put`` onto a
sharding.  It observes ``accum_psum_seconds`` and opens a
``telemetry.timeline.comm_span("parallel.redistribute")``, as in JAX.
:func:`gather_full` and :func:`scatter_shards` move a host's sharded tree
to and from its mesh rank 0, the rank that holds the host's Accumulator
peer (JAX: ``np.asarray`` of a sharded array, and ``device_put`` of a
host tree onto shardings).

Differentiable collectives and the gradient convention
------------------------------------------------------
The model-parallel modules (``ring_attention``, ``moe``, ``pipeline``)
run inside autograd, so two collectives carry a backward:
:func:`ring_permute` (its backward sends the gradient the other way round
the ring, JAX's transpose of ``ppermute``) and :func:`psum` (a sum over
one or more axes whose backward is again the sum over those axes, JAX's
transpose of ``psum``).  Their backward follows one convention, and every
module and the train step keep it:

- each rank's local loss is its token shard's share of the global loss
  (for the LM, the sum over its scored positions, over the global count);
- that share is counted once per group of ranks that hold the same tokens:
  ranks that hold the same tokens (over ``ep`` and ``pp``, which replicate
  the batch) each weigh their loss by one over the group's size;
- so the gradient a rank holds for any replicated value is a partial share,
  and a leaf's gradient is the sum over the ranks that hold a replica of it
  (``parallel.train`` sums replicated leaves over every axis, ``ep``-sharded
  experts over every axis but ``ep``).

Under it, Megatron's *g* (a sum feeding a replicated consumer: the MoE
combine over ``ep``, the pipeline's outputs over ``pp``, the MoE router's
global means over the token axes) takes :func:`psum`'s backward: every
replica's partial gradient summed.  Megatron's *f* (a replicated value
entering a rank-local region: the tokens each ``ep`` rank dispatches to its
experts) needs no collective at all: its partial gradients are summed with
the leaves' at the end of the step.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import telemetry
from ..utils import nest
from .mesh import NamedSharding, axis_sizes, sharding_of

_REG = telemetry.get_registry()
# Shared with the accumulator's sharded rounds (registration is idempotent):
# one histogram covers every in-mesh share-down / resharding hop.
_M_PSUM = _REG.histogram(
    "accum_psum_seconds",
    "host wall time in the in-mesh share-down / resharding of reduced "
    "tensors (parallel.redistribute and the sharded-round share-down)",
)
_M_STAGED = _REG.counter(
    "collectives_host_staged_bytes_total",
    "bytes of CUDA tensors staged through pinned host memory for a gloo "
    "collective (ranks sharing one card), each direction counted",
)


def _group(mesh, axis_name: str):
    return mesh.get_group(axis_name)


def _on_host_backend(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    _M_STAGED.inc(x.numel() * x.element_size())
    return host


def _host_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    _M_STAGED.inc(host.numel() * host.element_size())
    return host.to(like.device, non_blocking=True)


def axis_size(axis_name: str, mesh) -> int:
    """Size of the mesh dimension ``axis_name``."""
    return axis_sizes(mesh)[axis_name]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` as a new tensor."""
    if _on_host_backend(x, group):
        h = _to_host(x.detach())
        dist.all_reduce(h, group=group)
        return _back(h, x)
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def tree_psum(tree: Any, axis_name: str, mesh) -> Any:
    return nest.tree_map(lambda x: _all_reduce(x, _group(mesh, axis_name)), tree)


def tree_pmean(tree: Any, axis_name: str, mesh) -> Any:
    n = axis_size(axis_name, mesh)
    return nest.tree_map(lambda x: _all_reduce(x, _group(mesh, axis_name)) / n, tree)


class RingExchange:
    """One hop of a ring over a mesh axis, split in two: :meth:`start`
    posts the send of a tensor to the rank ``shift`` steps on and the
    receive from the rank ``shift`` steps back; :meth:`wait` returns what
    arrived, on the sender's device.  Work enqueued between the two (a
    chunk's kernels) overlaps the hop.  Every rank of the axis makes the
    same hops in the same order.  Where the group is gloo and the tensor
    lies on the card it is staged through pinned host memory; a received
    host copy can be sent on as it is (``wire=``), so a chunk that travels
    round the ring crosses the PCIe bus once each way a hop."""

    def __init__(self, axis_name: str, mesh, shift: int = 1):
        self.group = _group(mesh, axis_name)
        n = dist.get_world_size(self.group)
        me = dist.get_rank(self.group)
        self.dst = dist.get_global_rank(self.group, (me + shift) % n)
        self.src = dist.get_global_rank(self.group, (me - shift) % n)
        self._reqs = None

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it travels: a pinned host copy where the group is gloo
        and ``x`` is on the card, else ``x`` itself (contiguous)."""
        if _on_host_backend(x, self.group):
            return _to_host(x.detach())
        return x.detach().contiguous()

    def start(self, wire: torch.Tensor) -> None:
        self._like = wire
        self._recv = torch.empty_like(wire)
        self._reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, self.dst, self.group),
            dist.P2POp(dist.irecv, self._recv, self.src, self.group)])

    def wait(self, device: torch.device) -> tuple:
        """``(received on device, received as it travels)``."""
        for r in self._reqs:
            r.wait()
        self._reqs = None
        recv = self._recv
        if recv.device != device:
            _M_STAGED.inc(recv.numel() * recv.element_size())
            return recv.to(device, non_blocking=True), recv
        return recv, recv


def _ring_permute(x: torch.Tensor, axis_name: str, mesh, shift: int) -> torch.Tensor:
    hop = RingExchange(axis_name, mesh, shift)
    hop.start(hop.stage(x))
    return hop.wait(x.device)[0]


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh, shift):
        ctx.args = (axis_name, mesh, shift)
        return _ring_permute(x, axis_name, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        axis_name, mesh, shift = ctx.args
        return _ring_permute(g.contiguous(), axis_name, mesh, -shift), None, None, None


def ring_permute(x: torch.Tensor, axis_name: str, mesh, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` steps on along the axis and return
    what the rank ``shift`` steps back sent.  Differentiable: the backward
    sends the gradient ``shift`` steps back (JAX's transpose of
    ``ppermute``); every rank must then run that backward, in the same
    order."""
    return _RingPermute.apply(x, axis_name, mesh, shift)


_AXES_GROUPS: dict = {}


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank's coset over the mesh axes ``axes``
    (one axis: the mesh's own group; several: the ranks that differ only
    along those axes), and ``coords``: for each rank of that group, in
    group order, its index along each of ``axes``.  The first call for a
    given mesh and axes creates the groups of every coset, so every rank
    of the world makes it, in the same order; a rank outside ``mesh`` (the
    other half of a ``split_mesh``) gets ``(None, [])``."""
    axes = tuple(axes)
    key = (id(mesh), axes)
    if key not in _AXES_GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(grid.ndim) if d not in dims]
        moved = grid.permute(rest + dims).reshape(-1, math.prod(grid.shape[d] for d in dims))
        me = dist.get_rank()
        found = None
        for row in moved.tolist():
            g = (mesh.get_group(axes[0]) if len(axes) == 1
                 else dist.new_group(row, use_local_synchronization=False))
            if me in row:
                found = (g,)
        group = found[0] if found else None
        coords = []
        for i in range(0 if group is None else dist.get_world_size(group)):
            r = dist.get_global_rank(group, i)
            pos = (grid == r).nonzero()[0].tolist()
            coords.append({a: pos[d] for a, d in zip(axes, dims)})
        _AXES_GROUPS[key] = (group, coords, mesh)
    group, coords, _ = _AXES_GROUPS[key]
    return group, coords


def _psum_raw(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _all_reduce(x, axes_group(mesh, axes)[0])


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return _psum_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        axes, mesh = ctx.args
        return _psum_raw(g.contiguous(), axes, mesh), None, None


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh axis or axes ``axes`` (a name or a
    tuple of names), differentiable: the backward sums the ranks' partial
    gradients over the same axes (see the module docstring's convention).
    Axes of size 1, an empty tuple and no mesh give ``x`` itself."""
    if mesh is None:
        return x
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return x
    return _Psum.apply(x, axes, mesh)


def all_gather_axis(x: torch.Tensor, axis_name: str, mesh, axis: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``axis`` (JAX: tiled
    ``all_gather``)."""
    group = _group(mesh, axis_name)
    n = dist.get_world_size(group)
    src = x.detach().movedim(axis, 0).contiguous()
    staged = _on_host_backend(src, group)
    if staged:
        src = _to_host(src)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    if staged:
        out = _back(out, x)
    return out.movedim(0, axis)


def reduce_scatter_axis(x: torch.Tensor, axis_name: str, mesh, axis: int = 0) -> torch.Tensor:
    """The sum over ranks, split along ``axis``: rank i keeps block i (JAX:
    tiled ``psum_scatter``)."""
    group = _group(mesh, axis_name)
    n = dist.get_world_size(group)
    src = x.detach().movedim(axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter_axis: dim {axis} of {tuple(x.shape)} "
                         f"not divisible by {axis_name}={n}")
    staged = _on_host_backend(src, group)
    if staged:
        src = _to_host(src)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    if staged:
        out = _back(out, x)
    return out.movedim(0, axis)


def _shard_dims(sharding: Optional[NamedSharding]) -> list:
    """``(axis name, tensor dim)`` for every mesh axis a sharding shards
    over (empty when replicated or None)."""
    return [] if sharding is None else sharding.hits()


def _shard_dim(sharding: Optional[NamedSharding]):
    """``(axis name, tensor dim)`` of a sharding over one mesh axis, or None
    when replicated.  A sharding over several axes (``P("dp", "tp")``) has
    no single one: callers test :func:`_multi` first."""
    hits = _shard_dims(sharding)
    if not hits:
        return None
    if len(hits) > 1:
        raise ValueError(f"{sharding!r} shards over {len(hits)} mesh axes")
    return hits[0]


def _multi(sharding: Optional[NamedSharding]) -> bool:
    return len(_shard_dims(sharding)) > 1


def _block_index(sharding: NamedSharding, coords: dict) -> dict:
    """``{tensor dim: (block index, block count)}`` of the rank at mesh
    ``coords`` (a dim sharded over a tuple of axes: the first axis major)."""
    sizes = axis_sizes(sharding.mesh)
    out: dict = {}
    for name, d in sharding.hits():
        i, n = out.get(d, (0, 1))
        out[d] = (i * sizes[name] + coords[name], n * sizes[name])
    return out


def _mesh_blocks(local: List[torch.Tensor], shardings, shapes, dst: Optional[int]):
    """The whole tensors of ``local`` blocks sharded over any mesh axes,
    assembled from every rank of the mesh: one gather (``dst`` a mesh rank)
    or all-gather (``dst`` None) of the blocks packed flat per dtype over the
    whole mesh's group.  Returns the list of whole tensors where they land
    (None elsewhere)."""
    mesh = shardings[0].mesh
    group, coords = axes_group(mesh, tuple(mesh.mesh_dim_names))
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    out: List[Optional[torch.Tensor]] = [None] * len(local)
    for _, idx in _groups(range(len(local)), lambda i: local[i].dtype):
        like = local[idx[0]]
        src = torch.cat([local[i].detach().reshape(-1) for i in idx])
        staged = _on_host_backend(src, group)
        if staged:
            src = _to_host(src)
        if dst is None:
            flat = torch.empty(n * src.numel(), dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(flat, src, group=group)
            parts = list(flat.chunk(n))
        else:
            parts = [torch.empty_like(src) for _ in range(n)] if me == dst else None
            dist.gather(src, parts, dst=dist.get_global_rank(group, dst), group=group)
            if me != dst:
                continue
        if staged:
            parts = [_back(p, like) for p in parts]
        for r, part in enumerate(parts):
            off = 0
            for i in idx:
                k = local[i].numel()
                if out[i] is None:
                    out[i] = torch.empty(tuple(shapes[i]), dtype=like.dtype, device=like.device)
                view = out[i]
                for d, (b, cnt) in _block_index(shardings[i], coords[r]).items():
                    view = view.narrow(d, b * (shapes[i][d] // cnt), shapes[i][d] // cnt)
                view.copy_(part[off:off + k].view(local[i].shape))
                off += k
    return out


def _dtensor(local: torch.Tensor, sharding: NamedSharding, shape, stride=None):
    from torch.distributed.tensor import DTensor

    if stride is None:
        stride, acc = [], 1
        for d in reversed(shape):
            stride.append(acc)
            acc *= int(d)
        stride = tuple(reversed(stride))
    return DTensor.from_local(local, sharding.mesh, sharding.placements(),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def shard_of(x: torch.Tensor, sharding: Optional[NamedSharding]) -> torch.Tensor:
    """This rank's block of a full tensor ``x`` under ``sharding`` (a view;
    the whole of ``x`` when replicated)."""
    for name, d in _shard_dims(sharding):
        mesh = sharding.mesh
        x = x.chunk(axis_sizes(mesh)[name], dim=d)[mesh.get_local_rank(name)]
    return x


def _block_shape(t: torch.Tensor, d: int, n: int):
    """Shape of one of the ``n`` blocks of ``t`` along ``d``, moved to dim 0."""
    shape = list(t.shape)
    shape[d] //= n
    return [shape[d]] + shape[:d] + shape[d + 1:]


def _pack(tensors, dims, n: int) -> torch.Tensor:
    """Rank-major flat of the ``n`` blocks of every tensor along its dim:
    rank 0's blocks of every tensor, then rank 1's, ... (each block moved
    to dim 0 and flattened).  One collective then moves a whole tree."""
    blocks = [t.detach().movedim(d, 0).chunk(n, 0) for t, d in zip(tensors, dims)]
    return torch.cat([b[r].reshape(-1) for r in range(n) for b in blocks])


def _unpack_block(piece: torch.Tensor, tensors, dims, n: int) -> List[torch.Tensor]:
    """One rank's blocks (views of ``piece``, a rank's part of a packed
    flat), each back in its tensor's layout."""
    out, off = [], 0
    for t, d in zip(tensors, dims):
        shape = _block_shape(t, d, n)
        k = math.prod(shape)
        out.append(piece[off:off + k].view(shape).movedim(0, d))
        off += k
    return out


def _unpack_full(flat: torch.Tensor, tensors, dims, n: int) -> List[torch.Tensor]:
    """Whole tensors from a rank-major packed flat of all ``n`` ranks."""
    k = flat.numel() // n
    per_rank = [_unpack_block(flat[r * k:(r + 1) * k], tensors, dims, n) for r in range(n)]
    return [torch.cat([per_rank[r][j].movedim(d, 0) for r in range(n)]).movedim(0, d)
            for j, d in enumerate(dims)]


def _groups(indices, key):
    """Indices grouped by ``key(i)``, in first-seen order (identical on every
    rank, so the groups' collectives match)."""
    out: dict = {}
    for i in indices:
        out.setdefault(key(i), []).append(i)
    return out.items()


def redistribute(tree: Any, shardings: Any, block: bool = False) -> Any:
    """Reshard a tree onto target shardings (JAX: ``device_put`` onto a
    ``NamedSharding``).  Leaves are ``DTensor``s or plain tensors (taken as
    replicated full values); ``shardings`` is a tree of
    :class:`NamedSharding` matching ``tree`` or one broadcast to every
    leaf.  Returns ``DTensor``s in the target layout: the leaves a sharded
    layout leaves gather in one all-gather per axis and dtype (over the
    whole mesh for a leaf sharded over several axes), a replicated
    leaf that becomes sharded keeps its local block, nothing moves where
    the layout holds.  With ``block=True`` the call waits for the card, so
    the recorded time covers the copies.  Host time lands in
    ``accum_psum_seconds``."""
    from torch.distributed.tensor import DTensor

    leaves, treedef = nest.tree_flatten(tree)
    targets = ([shardings] * len(leaves) if isinstance(shardings, NamedSharding)
               else nest.tree_leaves(shardings))
    with _M_PSUM.time(), telemetry.timeline.comm_span("parallel.redistribute"):
        curs = [sharding_of(x) for x in leaves]
        local = [x.to_local() if isinstance(x, DTensor) else x for x in leaves]
        # Leaves sharded over several axes, or to become so, assemble whole
        # from the whole mesh; the rest move along their one axis.
        multi = [i for i in range(len(leaves)) if (_multi(curs[i]) or _multi(targets[i]))
                 and _shard_dims(curs[i]) != _shard_dims(targets[i]) and curs[i] is not None]
        if multi:
            wholes = _mesh_blocks([local[i] for i in multi], [curs[i] for i in multi],
                                  [tuple(leaves[i].shape) for i in multi], None)
            for i, whole in zip(multi, wholes):
                local[i] = whole
        have = [None if i in multi else _shard_dim(c) for i, c in enumerate(curs)]
        moving = [i for i in range(len(leaves))
                  if have[i] is not None and have[i] != (None if _multi(targets[i])
                                                         else _shard_dim(targets[i]))]
        for (_, name, _), idx in _groups(moving, lambda i: (id(curs[i].mesh), have[i][0],
                                                            local[i].dtype)):
            group = _group(curs[idx[0]].mesh, name)
            n = dist.get_world_size(group)
            blocks = [local[i] for i in idx]
            dims = [have[i][1] for i in idx]
            src = torch.cat([b.detach().movedim(d, 0).reshape(-1) for b, d in zip(blocks, dims)])
            staged = _on_host_backend(src, group)
            if staged:
                src = _to_host(src)
            flat = torch.empty(n * src.numel(), dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(flat, src, group=group)
            if staged:
                flat = _back(flat, blocks[0])
            fulls = [torch.empty(tuple(leaves[i].shape), dtype=local[i].dtype, device="meta")
                     for i in idx]
            for i, whole in zip(idx, _unpack_full(flat, fulls, dims, n)):
                local[i] = whole
        out = [_dtensor(shard_of(local[i], t), t, tuple(leaves[i].shape))
               for i, t in enumerate(targets)]
        if block:
            for leaf in out:
                if leaf.device.type == "cuda":
                    torch.cuda.current_stream(leaf.device).synchronize()
                    break
        return treedef.unflatten(out)


def gather_full(tree: Any, dst: int = 0) -> Optional[Any]:
    """Every ``DTensor`` leaf of ``tree`` in full on mesh rank ``dst``: one
    gather per mesh axis and dtype of the sharded leaves' blocks, or, when
    a leaf is sharded over several axes (``P("dp", "tp")``), one gather per
    dtype of every sharded leaf's block over the whole mesh.  Every rank of
    the mesh calls it with its own tree (same structure); rank ``dst`` gets
    the tree of full tensors, the others None.  Replicated DTensors give
    their local value, plain leaves pass through."""
    from torch.distributed.tensor import DTensor

    leaves, treedef = nest.tree_flatten(tree)
    out = [x.to_local() if isinstance(x, DTensor) else x for x in leaves]
    shs = [sharding_of(x) for x in leaves]
    sharded = [i for i, sh in enumerate(shs) if _shard_dims(sh)]
    if any(_multi(shs[i]) for i in sharded):
        # A leaf sharded over several axes: every sharded leaf assembles
        # from the whole mesh onto its rank ``dst``.
        group, _ = axes_group(shs[sharded[0]].mesh, tuple(shs[sharded[0]].mesh.mesh_dim_names))
        wholes = _mesh_blocks([out[i] for i in sharded], [shs[i] for i in sharded],
                              [tuple(leaves[i].shape) for i in sharded], dst)
        if dist.get_rank(group) != dst:
            return None
        for i, whole in zip(sharded, wholes):
            out[i] = whole
        return treedef.unflatten(out)
    on_dst = True
    for (_, name, _), idx in _groups(sharded, lambda i: (id(shs[i].mesh), _shard_dim(shs[i])[0],
                                                         out[i].dtype)):
        group = _group(shs[idx[0]].mesh, name)
        n = dist.get_world_size(group)
        on_dst = dist.get_rank(group) == dst
        dims = [_shard_dim(shs[i])[1] for i in idx]
        src = torch.cat([out[i].detach().movedim(d, 0).reshape(-1) for i, d in zip(idx, dims)])
        staged = _on_host_backend(src, group)
        like = out[idx[0]]
        if staged:
            src = _to_host(src)
        parts = [torch.empty_like(src) for _ in range(n)] if on_dst else None
        dist.gather(src, parts, dst=dist.get_global_rank(group, dst), group=group)
        if not on_dst:
            continue
        flat = torch.cat(parts)
        if staged:
            flat = _back(flat, like)
        fulls = [torch.empty(tuple(leaves[i].shape), dtype=out[i].dtype, device="meta")
                 for i in idx]
        for i, whole in zip(idx, _unpack_full(flat, fulls, dims, n)):
            out[i] = whole
    return treedef.unflatten(out) if on_dst else None


def scatter_shards(full: Optional[Any], template: Any, shardings: Sequence, mesh,
                   src: int = 0) -> List[torch.Tensor]:
    """Each rank's block of the full tree that mesh rank ``src`` holds.
    ``full`` is that tree on ``src`` (ignored elsewhere), ``template`` a
    tree of the same shapes and dtypes on every rank (e.g. the params; its
    values are not read), ``shardings`` the flat list of per-leaf
    :class:`NamedSharding` (None: replicated, broadcast whole over the
    mesh).  On a mesh with one axis of more than one rank: one scatter per
    dtype for the sharded leaves, one broadcast per dtype for the
    replicated ones.  Where several axes have more than one rank, or a leaf
    is sharded over several axes, the sharded leaves are broadcast whole
    over the mesh and cut.  Returns the flat list of blocks."""
    tleaves = nest.tree_leaves(template)
    fleaves = nest.tree_leaves(full) if full is not None else [None] * len(tleaves)
    out: List[Optional[torch.Tensor]] = [None] * len(tleaves)
    sizes = axis_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    live = [a for a in names if sizes[a] > 1]
    whole_mesh = len(live) > 1
    multi = [i for i, sh in enumerate(shardings) if _multi(sh) or (whole_mesh and _shard_dims(sh))]
    if multi:
        # Leaves sharded over several axes: broadcast whole over the whole
        # mesh, each rank keeps its block.
        whole = broadcast_tree({str(i): fleaves[i] for i in multi} if full is not None
                               else None, mesh, tleaves[multi[0]].device,
                               axis_name=names, src=src)
        for i in multi:
            out[i] = shard_of(whole[str(i)], shardings[i])
    hits = [None if i in multi else _shard_dim(sh) for i, sh in enumerate(shardings)]
    for (name, _), idx in _groups([i for i in range(len(tleaves)) if i not in multi], lambda i: (
            hits[i][0] if hits[i] is not None else None, tleaves[i].dtype)):
        group = (_group(mesh, name) if name is not None
                 else axes_group(mesh, names)[0] if len(names) > 1 else _group(mesh, names[0]))
        me = dist.get_rank(group)
        root = dist.get_global_rank(group, src)
        like = tleaves[idx[0]]
        staged = _on_host_backend(like, group)
        if name is None:  # replicated: one broadcast of the whole leaves
            n_el = sum(tleaves[i].numel() for i in idx)
            if me == src:
                buf = torch.cat([fleaves[i].detach().reshape(-1) for i in idx])
                buf = _to_host(buf) if staged else buf
            else:
                buf = (_host_empty((n_el,), like.dtype) if staged
                       else torch.empty(n_el, dtype=like.dtype, device=like.device))
            dist.broadcast(buf, root, group=group)
            buf = _back(buf, like) if staged else buf
            off = 0
            for i in idx:
                k = tleaves[i].numel()
                out[i] = buf[off:off + k].view(tleaves[i].shape)
                off += k
            continue
        n = dist.get_world_size(group)
        dims = [hits[i][1] for i in idx]
        tensors = [tleaves[i] for i in idx]
        k = sum(math.prod(_block_shape(t, d, n)) for t, d in zip(tensors, dims))
        recv = (_host_empty((k,), like.dtype) if staged
                else torch.empty(k, dtype=like.dtype, device=like.device))
        parts = None
        if me == src:
            packed = _pack([fleaves[i] for i in idx], dims, n)
            parts = list((_to_host(packed) if staged else packed).chunk(n))
        dist.scatter(recv, parts, src=root, group=group)
        recv = _back(recv, like) if staged else recv
        for i, b in zip(idx, _unpack_block(recv, tensors, dims, n)):
            out[i] = b
    return out


class _LeafSpec:
    """Shape and dtype of a broadcast leaf (pickled to the other ranks)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def broadcast_tree(tree: Optional[Any], mesh, device, axis_name: str = "dp",
                   src: int = 0) -> Any:
    """The tree of tensors that mesh rank ``src`` holds, on every rank of
    the axis, or of the axes when ``axis_name`` is a tuple (the others pass
    None; their copies land on ``device``).  The
    structure, shapes and dtypes travel first as one pickled object, then
    one broadcast per dtype of the leaves packed flat."""
    group = (axes_group(mesh, axis_name)[0] if isinstance(axis_name, tuple)
             else _group(mesh, axis_name))
    me = dist.get_rank(group)
    root = dist.get_global_rank(group, src)
    spec = [nest.tree_map(lambda x: _LeafSpec(x.shape, x.dtype), tree) if me == src else None]
    dist.broadcast_object_list(spec, root, group=group)
    if me == src:
        leaves, treedef = nest.tree_flatten(tree)
    else:
        specs, treedef = nest.tree_flatten(spec[0])
        leaves = [torch.empty(s.shape, dtype=s.dtype, device=device) for s in specs]
    out = list(leaves)
    for _, idx in _groups(range(len(leaves)), lambda i: leaves[i].dtype):
        like = leaves[idx[0]]
        n_el = sum(leaves[i].numel() for i in idx)
        staged = _on_host_backend(like, group)
        if me == src:
            buf = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
            buf = _to_host(buf) if staged else buf
        else:
            buf = (_host_empty((n_el,), like.dtype) if staged
                   else torch.empty(n_el, dtype=like.dtype, device=like.device))
        dist.broadcast(buf, root, group=group)
        if me == src:
            continue
        buf = _back(buf, like) if staged else buf
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = buf[off:off + k].view(leaves[i].shape)
            off += k
    return treedef.unflatten(out)


# --------------------------------------------------------------------------
# The inter-mesh handoff (the Sebulba split, disaggregated prefill)
# --------------------------------------------------------------------------


def _as_bytes(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every leaf's bytes, concatenated into one flat uint8 tensor on the
    leaves' device."""
    return torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in leaves])


def _spec_nbytes(spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _from_bytes(flat: torch.Tensor, specs) -> List[torch.Tensor]:
    out, off = [], 0
    for shape, dtype in specs:
        n = _spec_nbytes((shape, dtype))
        piece = flat[off:off + n]
        if off % torch.empty((), dtype=dtype).element_size():
            piece = piece.clone()  # a view must start on the dtype's alignment
        out.append(piece.view(dtype).reshape(shape))
        off += n
    return out


class _Sent:
    """An ``isend`` in flight; holds its buffer until :meth:`wait`."""

    __slots__ = ("work", "buf")

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        if self.buf is not None:
            self.work.wait()
            self.buf = None


class _Pending:
    """An ``irecv`` in flight: :meth:`wait` gives its leaves, counted by
    route on arrival.  A gloo work reads as completed only once waited on,
    and a wait that times out closes the link, so the handoff's watcher
    thread waits on each receive in turn and :meth:`done` reads its
    flag."""

    __slots__ = ("handoff", "work", "buf", "specs", "key", "on_host", "leaves", "event",
                 "error")

    def __init__(self, handoff, work, buf, specs, key, on_host):
        self.handoff, self.work, self.buf, self.specs = handoff, work, buf, specs
        self.key, self.on_host, self.leaves = key, on_host, None
        self.event, self.error = threading.Event(), None

    def done(self) -> bool:
        return self.event.is_set()

    def wait(self) -> List[torch.Tensor]:
        if self.leaves is None:
            self.event.wait()
            if self.error is not None:
                raise self.error
            h, buf = self.handoff, self.buf
            if h.counted:
                from ..batcher import count_handoff

                count_handoff(buf.numel(), h.route == "direct")
            h._digest(self.key, buf)
            if not self.on_host and buf.device != h.device:
                buf = buf.to(h.device, non_blocking=True)
            self.leaves, self.buf = _from_bytes(buf, self.specs), None
        return self.leaves


class Handoff:
    """Point-to-point crossings of tensor lists between ranks of two
    meshes, one process per rank: the port's counterpart of the JAX
    package's device-to-device ``device_put`` from one submesh's sharding to
    another's (the Sebulba actor-to-learner unrolls, the engine's
    prefill-to-decode K/V).  Nothing stops at a third rank.

    A message is one list of tensors sent as one flat byte buffer; the
    receiver names the ``(shape, dtype)`` of each leaf, and its leaves land
    on ``device``.  The route follows the rest of the plane
    (``mesh.choose_backend``, the backend the process group was made with,
    or ``backend``): NCCL sends CUDA tensors card to card (``"direct"``,
    counted in ``batcher_d2d_bytes_total``); gloo sends host buffers,
    staging CUDA tensors through pinned memory where ranks share a card
    (``"staged"``) or sending CPU tensors as they are (``"host"``), counted
    in ``batcher_staged_bytes_total``.  The receiver counts, unless
    ``counted=False`` (a control channel: tickets, commands, parameters).
    Messages between two ranks under one ``tag`` arrive in the order they
    were sent; NCCL matches in the order sent whatever the tag, so a
    direct handoff carries one direction of one stream per pair of ranks.

    ``digest=True`` on a send or receive folds its bytes into a running
    sha256 per peer and direction (:meth:`digests`), so two ranks can show
    that every byte of a stream arrived as sent (on the direct route that
    costs a copy to the host).  Every rank of the world constructs the
    handoff (its process group is created collectively)."""

    def __init__(self, device, backend: Optional[str] = None, counted: bool = True):
        self.device = torch.device(device)
        backend = backend or dist.get_backend()
        self.group = dist.new_group(backend=backend)
        if backend == "nccl":
            self.route = "direct"
        else:
            self.route = "staged" if self.device.type == "cuda" else "host"
        self.counted = counted
        self._digests: dict = {}
        self._watch = None  # the watcher's queue of receives, once it runs

    def _watcher(self, q) -> None:
        while (p := q.get()) is not None:
            try:
                p.work.wait()
            except BaseException as e:  # noqa: BLE001 - raised again by the receive's wait()
                p.error = e
            p.event.set()

    def close(self) -> None:
        """Stop the watcher thread (every receive posted has been waited)."""
        if self._watch is not None:
            self._watch.put(None)
            self._watch = None

    def _digest(self, key, buf: torch.Tensor) -> None:
        if key is None:
            return
        import hashlib

        h = self._digests.setdefault(key, hashlib.sha256())
        h.update(buf.cpu().numpy().tobytes())

    def digests(self) -> dict:
        """``{"tx:<peer>" / "rx:<peer>": sha256 hex}`` of every stream sent or
        received with ``digest=True``."""
        return {f"{d}:{peer}": h.hexdigest() for (d, peer), h in sorted(self._digests.items())}

    def isend(self, leaves: Sequence[torch.Tensor], dst: int, tag: int = 0,
              digest: bool = False) -> _Sent:
        buf = _as_bytes(leaves)
        if self.route != "direct" and buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf)
            buf = host
        self._digest(("tx", dst) if digest else None, buf)
        return _Sent(dist.isend(buf, dst, group=self.group, tag=tag), buf)

    def irecv(self, specs, src: int, tag: int = 0, digest: bool = False,
              on_host: bool = False) -> _Pending:
        """Post a receive; ``on_host`` keeps a gloo message's leaves in host
        memory instead of copying them to ``device``."""
        n = sum(_spec_nbytes(s) for s in specs)
        if self.route == "direct":
            buf = torch.empty((n,), dtype=torch.uint8, device=self.device)
        else:
            buf = torch.empty((n,), dtype=torch.uint8, pin_memory=self.route == "staged")
        work = dist.irecv(buf, src, group=self.group, tag=tag)
        pending = _Pending(self, work, buf, list(specs), ("rx", src) if digest else None,
                           on_host)
        if self._watch is None:
            self._watch = queue.SimpleQueue()
            threading.Thread(target=self._watcher, args=(self._watch,), daemon=True,
                             name="handoff-watch").start()
        self._watch.put(pending)
        return pending

    def send(self, leaves: Sequence[torch.Tensor], dst: int, tag: int = 0) -> None:
        self.isend(leaves, dst, tag).wait()

    def recv(self, specs, src: int, tag: int = 0, on_host: bool = False) -> List[torch.Tensor]:
        return self.irecv(specs, src, tag, on_host=on_host).wait()


class UnrollHandoff:
    """The Sebulba stream of ``[T+1, B, ...]`` unrolls (with their
    ``[B, ...]`` initial core states) from the ranks of an actor mesh to the
    ranks of a learner mesh, each learner ``dp`` rank receiving only its
    columns of each learner batch.

    The actor ranks' unrolls, taken in actor-rank order, make one stream of
    columns: unroll ``u`` of actor rank ``r`` holds stream columns ``u·Bt
    + r·Ba`` onwards (``Ba`` columns each, ``Bt`` over all actor ranks), in
    the global env order of the unsharded rollout.  Learner batch ``k`` is
    stream columns ``[k·bs, (k+1)·bs)``, the batches the JAX package's
    Batcher cuts from the same stream, and learner ``dp`` rank ``l`` takes
    its block ``[k·bs + l·c, k·bs + (l+1)·c)``, ``c = bs / dp`` (every
    ``tp`` rank of that ``dp`` index receives it).  Both sides enumerate
    the pieces where a source run meets a destination block in stream
    order, so each pair of ranks sends and receives the same pieces in the
    same order with no message saying which.  On the host routes every
    piece's bytes are digested on both sides (``handoff.digests()``), so
    the ranks can show that the columns arrived as sent.

    ``specs`` is ``((unroll leaf specs, treedef), (core leaf specs,
    treedef))`` (``rollout.anakin_column_specs``): ``(shape, dtype)`` of one
    column of each leaf.  Every rank of the world constructs it (it makes a
    :class:`Handoff`)."""

    TAG = 3

    def __init__(self, actor_mesh, learner_mesh, unroll_width: int, batch_size: int, specs,
                 device):
        from .mesh import mesh_ranks

        self.actor_ranks = mesh_ranks(actor_mesh)
        self.Ba = unroll_width
        self.Bt = unroll_width * len(self.actor_ranks)
        self.bs = batch_size
        sizes = axis_sizes(learner_mesh)
        self.dp = sizes.get("dp", 1)
        if batch_size % self.dp:
            raise ValueError(f"learner dp={self.dp} must divide batch_size={batch_size}")
        self.c = batch_size // self.dp
        # Learner ranks by dp index (each tp rank of a dp index takes its block).
        names = list(learner_mesh.mesh_dim_names)
        grid = learner_mesh.mesh
        if "dp" in names:
            grid = grid.movedim(names.index("dp"), 0)
        self.learners = [row.reshape(-1).tolist() for row in grid.reshape(self.dp, -1)]
        (self.unroll_specs, self.unroll_def), (self.core_specs, self.core_def) = specs
        self.handoff = Handoff(device)
        self.digest = self.handoff.route != "direct"
        me = dist.get_rank()
        self.actor_index = self.actor_ranks.index(me) if me in self.actor_ranks else None
        self.dp_index = next((l for l, rs in enumerate(self.learners) if me in rs), None)
        self.taken = 0  # learner batches this rank has taken
        self._pending = None  # the receives posted for the next batch
        self._sent: list = []  # (unroll, sends) of this actor rank

    # -- the piece schedule ------------------------------------------------
    def _src_pieces(self, r: int, u: int):
        """(dp index, first column, width) of actor rank r's unroll u."""
        s, end = u * self.Bt + r * self.Ba, u * self.Bt + (r + 1) * self.Ba
        while s < end:
            k, off = divmod(s, self.bs)
            l = off // self.c
            e = min(end, k * self.bs + (l + 1) * self.c)
            yield l, s - (u * self.Bt + r * self.Ba), e - s
            s = e

    def _dst_pieces(self, l: int, k: int, limit: Optional[int] = None):
        """(actor index, unroll, width) of learner dp rank l's block of
        batch k, stream columns below ``limit`` only."""
        s, end = k * self.bs + l * self.c, k * self.bs + (l + 1) * self.c
        if limit is not None:
            end = min(end, limit)
        while s < end:
            u, off = divmod(s, self.Bt)
            r = off // self.Ba
            e = min(end, u * self.Bt + (r + 1) * self.Ba)
            yield r, u, e - s
            s = e

    def unroll_bytes(self, width: int) -> int:
        """The bytes of ``width`` columns of an unroll and its core state."""
        return sum(_spec_nbytes(s) for s in self._piece_specs(width))

    def _piece_specs(self, width: int) -> list:
        return ([((shape[0], width, *shape[1:]), dt) for shape, dt in self.unroll_specs]
                + [((width, *shape), dt) for shape, dt in self.core_specs])

    # -- the actor side ----------------------------------------------------
    def send(self, u: int, unroll, core) -> None:
        """Actor rank: send unroll ``u`` (a tree of ``[T+1, Ba, ...]``
        leaves) and its initial core state (``[Ba, ...]``), every learner
        rank its pieces; returns once they are on their way.  The sends of
        unroll ``u - 2`` and before are waited for and released: a caller
        that runs at most two unrolls ahead of the learner finds them
        done."""
        for _, sends in [g for g in self._sent if g[0] <= u - 2]:
            for w in sends:
                w.wait()
        self._sent = [g for g in self._sent if g[0] > u - 2]
        unroll, core = nest.tree_flatten(unroll)[0], nest.tree_flatten(core)[0]
        sends = []
        for l, a, w in self._src_pieces(self.actor_index, u):
            leaves = [x[:, a:a + w] for x in unroll] + [x[a:a + w] for x in core]
            for dst in self.learners[l]:
                sends.append(self.handoff.isend(leaves, dst, self.TAG, digest=self.digest))
        self._sent.append((u, sends))

    def wait_sent(self) -> None:
        for _, sends in self._sent:
            for w in sends:
                w.wait()
        self._sent = []

    # -- the learner side --------------------------------------------------
    def _post(self, limit: Optional[int] = None) -> list:
        return [self.handoff.irecv(self._piece_specs(w), self.actor_ranks[r], self.TAG,
                                   digest=self.digest)
                for r, u, w in self._dst_pieces(self.dp_index, self.taken, limit)]

    def post(self) -> None:
        """Learner rank: post the receives of its block of the next batch
        (once; the caller posts only batches whose unrolls are on their
        way)."""
        if self._pending is None:
            self._pending = self._post()

    def ready(self) -> bool:
        """Whether the posted block of the next batch has arrived."""
        return self._pending is not None and all(p.done() for p in self._pending)

    def take(self) -> tuple:
        """This rank's block of the next batch: ``(unroll tree [T+1, c,
        ...], core tree [c, ...])``."""
        self.post()
        parts = [p.wait() for p in self._pending]
        self._pending = None
        self.taken += 1
        leaves = [torch.cat([p[i] for p in parts], dim=1 if i < len(self.unroll_specs) else 0)
                  if len(parts) > 1 else parts[0][i] for i in range(len(parts[0]))]
        nu = len(self.unroll_specs)
        return self.unroll_def.unflatten(leaves[:nu]), self.core_def.unflatten(leaves[nu:])

    def drain(self, unrolls: int) -> None:
        """Learner rank: receive and drop every piece of the first
        ``unrolls`` unrolls this rank has not taken (the actors' last sends
        must land before they leave)."""
        if self._pending is not None:
            for p in self._pending:
                p.wait()
            self._pending = None
            self.taken += 1
        limit = unrolls * self.Bt
        while self.taken * self.bs < limit:
            for p in self._post(limit):
                p.wait()
            self.taken += 1
