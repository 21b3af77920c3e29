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
"""

from __future__ import annotations

import math
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


def ring_permute(x: torch.Tensor, axis_name: str, mesh, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` steps on along the axis and return
    what the rank ``shift`` steps back sent."""
    group = _group(mesh, axis_name)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    staged = _on_host_backend(x, group)
    send = _to_host(x.detach()) if staged else x.detach().contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return _back(recv, x) if staged else recv


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


def _shard_dim(sharding: Optional[NamedSharding]):
    """``(axis name, tensor dim)`` of a sharding's one sharded dim, or None
    when replicated.  A tensor sharded over two mesh axes comes with the
    model-parallel slice."""
    if sharding is None:
        return None
    hits = [(s, d) for d, s in enumerate(sharding.spec) if s is not None]
    if not hits:
        return None
    if len(hits) > 1 or isinstance(hits[0][0], tuple):
        raise NotImplementedError("a tensor sharded over several mesh axes: "
                                  "not yet ported (slice 9b)")
    return hits[0]


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
    hit = _shard_dim(sharding)
    if hit is None:
        return x
    name, d = hit
    mesh = sharding.mesh
    n = axis_sizes(mesh)[name]
    i = mesh.get_local_rank(name)
    return x.chunk(n, dim=d)[i]


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
    layout leaves gather in one all-gather per axis and dtype, a replicated
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
        have = [_shard_dim(c) for c in curs]
        moving = [i for i in range(len(leaves))
                  if have[i] is not None and have[i] != _shard_dim(targets[i])]
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
    gather per mesh axis and dtype of the sharded leaves' blocks.  Every
    rank of the mesh calls it with its own tree (same structure); rank
    ``dst`` gets the tree of full tensors, the others None.  Replicated
    DTensors give their local value, plain leaves pass through."""
    from torch.distributed.tensor import DTensor

    leaves, treedef = nest.tree_flatten(tree)
    out = [x.to_local() if isinstance(x, DTensor) else x for x in leaves]
    shs = [sharding_of(x) for x in leaves]
    sharded = [i for i, sh in enumerate(shs) if _shard_dim(sh) is not None]
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
                   axis_name: str = "dp", src: int = 0) -> List[torch.Tensor]:
    """Each rank's block of the full tree that mesh rank ``src`` holds.
    ``full`` is that tree on ``src`` (ignored elsewhere), ``template`` a
    tree of the same shapes and dtypes on every rank (e.g. the params),
    ``shardings`` the flat list of per-leaf :class:`NamedSharding` (None:
    replicated, broadcast whole over ``axis_name``).  One scatter per axis
    and dtype for the sharded leaves, one broadcast per dtype for the
    replicated ones.  Returns the flat list of blocks."""
    tleaves = nest.tree_leaves(template)
    fleaves = nest.tree_leaves(full) if full is not None else [None] * len(tleaves)
    hits = [_shard_dim(sh) for sh in shardings]
    out: List[Optional[torch.Tensor]] = [None] * len(tleaves)
    for (name, _), idx in _groups(range(len(tleaves)), lambda i: (
            hits[i][0] if hits[i] is not None else None, tleaves[i].dtype)):
        group = _group(mesh, name if name is not None else axis_name)
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
    the axis (the others pass None; their copies land on ``device``).  The
    structure, shapes and dtypes travel first as one pickled object, then
    one broadcast per dtype of the leaves packed flat."""
    group = _group(mesh, axis_name)
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
