"""Train-step construction on a mesh of ranks, with the in-mesh gradient
reduction and the hook-streamed backward.

The JAX package states the data-parallel step as a sharding annotation and
lets XLA insert the gradient all-reduce or reduce-scatter.  Here each rank
is a process: the step slices its ``dp`` block of the batch, runs forward
and backward on it, and reduces the gradients over the ``dp`` group
itself (``all_reduce`` for replicated leaves, ``reduce_scatter`` along the
sharded dim for ``"fsdp"``/``"params"``), returning them as ``DTensor``s.

``params`` is a tree (e.g. ``dict(model.named_parameters())``) of leaf
tensors with ``requires_grad``; ``loss_fn(params, batch, rng) -> (loss,
aux)`` computes from those tensors and returns this rank's *local mean*
loss (its blocks are equal, so the mean of the ranks' gradients is the
global-batch gradient).

``overlap_grads=True`` streams the gradients in PyTorch's idiom: one
backward, with ``Tensor.register_post_accumulate_grad_hook`` on every
leaf.  The leaves (in flatten order) are cut into contiguous runs at the
flat-bucket grid (``buckets.bucket_bytes``); when the last leaf of a run
has its gradient, the hook reduces the run over the mesh and hands it to
``buckets.GradientStream.deliver``, whose non-blocking D2H records the CUDA
event the consumer waits on.  So ``Accumulator.reduce_gradients`` launches
each bucket's wire op while the rest of the backward is still queued.  The
values are the barrier step's, bit for bit.  JAX cuts its step into two
jits at ``overlap_cut``; the hooks need no cut, so ``overlap_cut`` is
accepted and has no effect.

The step with an optimizer (:func:`_optimizer_step`) serves every static
mesh: ``dp`` alone, and the model-parallel axes ``tp``, ``sp``, ``ep`` and
``pp``, whose collectives run inside ``loss_fn`` (the tensor-parallel
gathers, ring attention, the MoE combine, the pipeline) under the gradient
convention of ``parallel.collectives``.  ``batch_spec`` names the axes that
shard the tokens (``P("dp", None)``, ``P("dp", "sp")`` for a ring LM); the
other axes hold replicas of them.  ``loss_fn`` returns this rank's local
loss, whose mean over the token shards is the global loss (equal on ranks
that hold the same tokens); the step weighs it by one over the replica
count before the backward, sums each leaf's gradient over the axes that
hold a replica of it and divides by the token shards.  A leaf's held axes
are those its parameter is cut over: ``tp`` for the blocks
``parallel.tensor_parallel.shard_model`` cut (tagged on the parameter),
``ep`` for experts (``params_sharding``); ``dp`` in ``params_sharding`` is
FSDP's gradient layout and cuts no parameter.  So replicated leaves are
summed over every axis, ``tp`` blocks over every axis but ``tp``, experts
over every axis but ``ep``.  The loss and the aux it returns are the global
ones.

``grad_spec=`` (the elastic cohort's mesh hosts) weighs the loss and
reduces every leaf the same way, through the same helper
(:class:`_Reduction`), then lays the gradients out in the target layout:
a leaf sharded over ``dp`` and ``tp`` comes back as a ``DTensor`` with two
``Shard`` placements.  There a sum over several axes runs one axis at a
time (the model axes in mesh order, ``dp`` last), so two ranks an axis add
in one order whatever the leaves' grouping: the barrier and the overlap
stream agree bit for bit.  The optimizer path sums each group of leaves
in one all-reduce over all its axes, which moves fewer bytes; it agrees
with them up to the order of the additions, and bit for bit where a
leaf's sum runs over one axis.

The hooks of ``overlap_grads=True`` reduce from inside the backward, where
ring attention, the MoE and the pipeline make their own collectives.  Every
rank of a reduction group must post the same collectives in the same
order, so every rank must reach the same leaves in the same order: the
ranks run one graph (the same modules, the same autograd nodes; a ring's
hops and a pipeline's ticks are each inside one node, ``_Ring`` and
``_Pipeline``), and every leaf gets a gradient on every rank (the
pipeline returns zeros for the stages a rank does not run, the MoE runs
every expert it holds).  A leaf the backward reaches on no rank goes out
after it, on every rank alike.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import buckets, telemetry
from ..telemetry import devmon
from ..utils import nest
from .collectives import (_all_reduce, _dtensor, _groups, _pack, _unpack_block, axes_group,
                          gather_full, reduce_scatter_axis, shard_of)
from .mesh import (NamedSharding, PartitionSpec as P, axis_sizes, flax_shape, layout_dims,
                   mesh_ranks, replicated)

_REG = telemetry.get_registry()
_M_STEPS = _REG.counter("train_steps_total", "train-step invocations")
_M_DISPATCH = _REG.histogram(
    "train_step_dispatch_seconds",
    "host time in the train step call (dispatch, not device time)",
)

# Each built step gets its own devmon name: two different train steps in
# one process (tests, A/B runs) must not read as each other.
_STEP_SEQ = itertools.count()


def _instrument_step(fn, name: Optional[str] = None):
    if name is None:
        n = next(_STEP_SEQ)
        name = "parallel.train_step" + (f"#{n}" if n else "")

    def timed_step(*args, **kwargs):
        # dispatch_span feeds the timeline capture windows (the step
        # anchors for overlap/exposure attribution); free when none open.
        with _M_DISPATCH.time(), devmon.dispatch_span(name):
            out = fn(*args, **kwargs)
        _M_STEPS.inc()
        return out

    timed_step.inner = fn
    return timed_step


def _spec_axes(spec) -> set:
    """The mesh axes a PartitionSpec names."""
    out = set()
    for s in spec or ():
        if s is not None:
            out |= set(s) if isinstance(s, tuple) else {s}
    return out


def _held_axes(p, sharding) -> set:
    """The mesh axes parameter ``p`` is cut over: its ``tp`` tag from
    ``shard_model``, else ``sharding``'s axes but ``dp`` (FSDP's gradient
    layout) and ``tp`` (a leaf ``shard_model`` left whole)."""
    from .tensor_parallel import held_sharding

    tag = held_sharding(p)
    if tag is not None:
        return _spec_axes(tag.spec)
    return _spec_axes(sharding.spec if sharding is not None else ()) - {"dp", "tp"}


class _Reduction:
    """How a step on a mesh weighs its loss and reduces its gradients (the
    module docstring), for the optimizer path, the ``grad_spec`` barrier
    and the overlap hooks alike: ``n_tok`` token shards from the axes
    ``batch_spec`` names, ``n_rep`` replicas of each; per leaf, the live
    axes its parameter is not held over, in summing order."""

    def __init__(self, mesh, params_sharding, batch_spec):
        sizes = axis_sizes(mesh) if mesh is not None else {}
        self.mesh = mesh
        self.live = [a for a, n in sizes.items() if n > 1]
        tok = [a for a in self.live if a in _spec_axes(batch_spec)]
        self.n_tok = int(np.prod([sizes[a] for a in tok])) if tok else 1
        self.n_rep = int(np.prod([sizes[a] for a in self.live])) // self.n_tok
        self._params_sharding = params_sharding
        self._resolved: Optional[tuple] = None

    def weigh(self, loss):
        """The loss a rank takes the backward of: its share over the ranks
        that hold the same tokens."""
        return loss / self.n_rep if self.n_rep > 1 else loss

    def _resolve(self, params) -> tuple:
        if self._resolved is None:
            leaves = nest.tree_leaves(params)
            ps = self._params_sharding
            shs = ([None] * len(leaves) if ps is None or isinstance(ps, str)
                   else nest.tree_leaves(ps))
            helds = [_held_axes(p, sh) for p, sh in zip(leaves, shs)]
            axes = [tuple(a for a in self.live if a != "dp" and a not in held)
                    + (("dp",) if "dp" in self.live and "dp" not in held else ())
                    for held in helds]
            self._resolved = (helds, axes)
        return self._resolved

    def helds(self, params) -> List[set]:
        """Per leaf (flatten order): the mesh axes its parameter is cut over."""
        return self._resolve(params)[0]

    def axes(self, params) -> List[tuple]:
        """Per leaf (flatten order): the axes its gradient is summed over,
        the model axes first, ``dp`` last."""
        return self._resolve(params)[1]

    def global_mean(self, x):
        """A rank's local loss or aux value as the global one."""
        if not isinstance(x, torch.Tensor) or not self.live:
            return x
        return _all_reduce(x.detach().to(torch.float32) / self.n_rep,
                           axes_group(self.mesh, tuple(self.live))[0]) / self.n_tok


def _sum_axes(flat: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``flat`` over ``axes``, one axis's group at a time."""
    for a in axes:
        flat = _all_reduce(flat, mesh.get_group(a))
    return flat


def _optimizer_step(loss_fn, optimizer, mesh, red: _Reduction, batch_spec):
    """The step with an optimizer, on any mesh or none (see the module
    docstring): ``step(params, opt_state, batch, rng) -> (params,
    opt_state, loss, aux)`` with the global loss and aux.
    ``step.grads(params, batch, rng) -> (loss, aux)`` runs the same forward,
    backward and reduction and leaves the reduced gradients in the leaves'
    ``.grad``, without the update (a warm-up or a probe)."""
    n_tok = red.n_tok

    def grads(params, batch, rng):
        leaves = nest.tree_leaves(params)
        for p in leaves:
            p.grad = None
        if mesh is not None:
            batch = _slice_batch(batch, mesh, batch_spec)
        loss, aux = loss_fn(params, batch, rng)
        red.weigh(loss).backward()
        axes = red.axes(params)
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for (ax, _), idx in _groups(range(len(leaves)), lambda i: (axes[i], gs[i].dtype)):
            if not ax and n_tok == 1:
                continue
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            if ax:  # one all-reduce over the group of all of them
                flat = _all_reduce(flat, axes_group(mesh, [a for a in red.live if a in ax])[0])
            flat = flat.div_(n_tok)
            off = 0
            for i in idx:
                leaves[i].grad = flat[off:off + gs[i].numel()].view(gs[i].shape)
                off += gs[i].numel()
        return red.global_mean(loss.detach()), nest.tree_map(red.global_mean, aux)

    def step(params, opt_state, batch, rng):
        loss, aux = grads(params, batch, rng)
        optimizer.step()
        return params, opt_state, loss, aux

    step.grads = grads
    return step


def fsdp_spec(x, axis: str = "dp", min_size: int = 2**16, held=None) -> P:
    """ZeRO-3-style spec: shard the largest axis of big params.  ``held``
    (a :class:`NamedSharding`, for ``x`` of the whole shape): the
    model-parallel axes the parameter is cut over, whose spec is kept (one
    entry per dim) while ``axis`` takes the largest dim they leave free."""
    shape = tuple(x.shape)
    if held is None:
        spec, order = [None] * len(shape), list(range(len(shape)))
    else:
        spec = list(held.spec) + [None] * (len(shape) - len(held.spec))
        order = list(held.dims) if held.dims is not None else list(range(len(shape)))
    free = [d for d in range(len(shape)) if spec[order.index(d)] is None]
    if not free or int(np.prod(shape)) < min_size:
        return P(*spec) if held is not None else P()
    spec[order.index(max(free, key=lambda d: shape[d]))] = axis
    return P(*spec)


def param_shardings(params, mesh, mode: str = "replicated", axis: str = "dp", held=None):
    """Tree of :class:`NamedSharding` for the params: "replicated" (pure DP)
    or "fsdp" (largest-axis sharding for big leaves, where ``axis``
    divides that dim).  ``held`` ("fsdp"; a tree like ``params``): each
    leaf's :class:`NamedSharding` of the model-parallel axes it is cut over
    (``fsdp_spec``), ``params`` then leaves of the whole shapes."""
    if mode == "replicated":
        return nest.tree_map(lambda _: replicated(mesh), params)
    if mode == "fsdp":
        sizes = axis_sizes(mesh)

        def spec_of(x, h=None):
            spec = fsdp_spec(x, axis, held=h)
            sh = NamedSharding(mesh, spec, None if h is None else h.dims)
            if any(a == axis and x.shape[d] % sizes[a] for a, d in sh.hits()):
                # Only keep the sharding if the axis divides evenly.
                sh = replicated(mesh) if h is None else NamedSharding(
                    mesh, P(*(None if a == axis else a for a in spec)), h.dims)
            return sh

        return nest.tree_map(spec_of, params) if held is None else nest.tree_map(
            spec_of, params, held)
    raise ValueError(f"unknown mode {mode!r}")


def auto_shardings(params, mesh, tp_axis: str = "tp", dp_axis: str = "dp",
                   tp_min: int = 16, fsdp_min: int = 2**12):
    """The JAX package's TP+FSDP composition on one mesh, leaf for leaf:
    ``tp`` on the last axis of every kernel of two or more dims (its output
    features) when that axis is at least ``tp_min`` and the ``tp`` size
    divides it, then FSDP over ``dp`` on the largest remaining divisible
    axis of leaves of ``fsdp_min`` elements or more.  Decided on the flax
    leaf's shape: a conv kernel the port holds as ``[out, in, kh, kw]``
    gets flax's spec (``tp`` on ``out``) with the torch dims in ``dims``
    (``mesh.layout_dims``).  ``parallel.tensor_parallel.shard_model`` cuts
    a model to this layout's ``tp`` blocks; ``dp`` stays a layout of the
    reduced gradients (parameters are whole over ``dp``)."""
    sizes = axis_sizes(mesh)
    has_tp = sizes.get(tp_axis, 1) > 1
    has_dp = sizes.get(dp_axis, 1) > 1

    def spec_of(x):
        shape = flax_shape(tuple(x.shape))
        spec = [None] * len(shape)
        if has_tp and len(shape) >= 2 and shape[-1] >= tp_min and shape[-1] % sizes[tp_axis] == 0:
            spec[-1] = tp_axis
        if has_dp and int(np.prod(shape)) >= fsdp_min:
            cand = max((d for d in range(len(shape)) if spec[d] is None),
                       key=lambda d: shape[d], default=None)
            if cand is not None and shape[cand] % sizes[dp_axis] == 0:
                spec[cand] = dp_axis
        return NamedSharding(mesh, P(*spec), layout_dims(tuple(x.shape)))

    return nest.tree_map(spec_of, params)


def _slice_batch(batch, mesh, spec: P):
    """This rank's block of every batch leaf along the dims ``spec`` shards."""
    sizes = axis_sizes(mesh)

    def take(x):
        for d, name in enumerate(spec):
            if name is not None and d < x.ndim and name in sizes:
                x = x.chunk(sizes[name], dim=d)[mesh.get_local_rank(name)]
        return x.contiguous()

    return nest.tree_map(take, batch)


def _reduce_leaves(grads: List[torch.Tensor], shardings: List[NamedSharding], n: int,
                   helds: List[set], axes: List[tuple]) -> list:
    """Gradient leaves reduced into their target shardings' layouts, as
    DTensors.  ``grads`` are the leaves' local gradients: whole, or the
    block of the axes ``helds[i]`` their parameter is cut over (a ``tp``
    block, an ``ep`` expert block), which must be among the target's;
    ``axes[i]`` the axes they are summed over (:class:`_Reduction`), ``n``
    the token shards they are divided by.  Per leaf: a sum over those axes
    but ``dp`` where the target scatters it over ``dp``; its block of the
    target's other model-parallel axes; and, where the target shards it
    over ``dp``, one reduce-scatter of the blocks packed rank-major (each
    rank keeps its block of every leaf).  One collective per group of
    leaves that share those axes and a dtype."""
    mesh = shardings[0].mesh
    sizes = axis_sizes(mesh)
    full_shapes, scatter, sums = [], [], []
    for g, sh, held, ax in zip(grads, shardings, helds, axes):
        target = _spec_axes(sh.spec)
        if not held <= target:
            raise ValueError(f"a gradient held over {sorted(held)} cannot take the layout {sh!r}")
        full_shapes.append(_full_shape(g.shape, sh, held))
        scatter.append("dp" in target and "dp" in ax)
        sums.append(tuple(a for a in ax if not (a == "dp" and scatter[-1])))
    out: list = [None] * len(grads)
    red: list = [None] * len(grads)
    for (ax, _), idx in _groups(range(len(grads)), lambda i: (sums[i], grads[i].dtype)):
        if not ax:
            for i in idx:
                red[i] = grads[i]
            continue
        flat = _sum_axes(torch.cat([grads[i].reshape(-1) for i in idx]), ax, mesh)
        off = 0
        for i in idx:
            red[i] = flat[off:off + grads[i].numel()].view(grads[i].shape)
            off += grads[i].numel()
    for i, (sh, held) in enumerate(zip(shardings, helds)):
        cut = [(a, d) for a, d in sh.hits() if a not in held and a != "dp"]
        if cut:  # the target's model-parallel blocks of a leaf held whole
            red[i] = shard_of(red[i], _hits_sharding(mesh, cut, red[i].ndim))
    for (sharded, _), idx in _groups(range(len(grads)), lambda i: (scatter[i], red[i].dtype)):
        if sharded:
            dims = [dict(shardings[i].hits())["dp"] for i in idx]
            flat = reduce_scatter_axis(_pack([red[i] for i in idx], dims, sizes["dp"]), "dp",
                                       mesh)
            locals_ = _unpack_block(flat.div_(n), [red[i] for i in idx], dims, sizes["dp"])
        else:
            locals_ = [red[i] / n if n > 1 else red[i] for i in idx]
        for i, local in zip(idx, locals_):
            out[i] = _dtensor(local, shardings[i], full_shapes[i])
    return out


def _full_shape(shape, sharding: NamedSharding, held: set) -> tuple:
    """The whole shape of a leaf held as a block of ``held`` axes, whose
    target layout ``sharding`` names the dims they cut."""
    sizes = axis_sizes(sharding.mesh)
    out = list(shape)
    for a, d in sharding.hits():
        if a in held:
            out[d] *= sizes[a]
    return tuple(out)


def _hits_sharding(mesh, hits, ndim: int) -> NamedSharding:
    """A sharding of a tensor of ``ndim`` dims over ``hits`` ((axis, dim)
    pairs, each dim once)."""
    spec = [None] * ndim
    for a, d in hits:
        spec[d] = a
    return NamedSharding(mesh, P(*spec))


def _leaf_runs(sizes: List[int], itemsize: int):
    """Cut leaves (flatten order) into contiguous runs that end at the first
    leaf boundary on or past each flat-bucket grid boundary."""
    grid = max(1, buckets.bucket_bytes() // itemsize)
    runs, start, off, next_cut = [], 0, 0, grid
    for i, n in enumerate(sizes):
        off += n
        if off >= next_cut or i == len(sizes) - 1:
            runs.append((start, i + 1))
            start = i + 1
            next_cut = (off // grid + 1) * grid
    return runs


def make_train_step(
    loss_fn: Callable,
    optimizer: Optional[torch.optim.Optimizer] = None,
    mesh=None,
    params_sharding=None,
    batch_spec: Optional[P] = None,
    grad_spec=None,
    overlap_grads: bool = False,
    overlap_cut: Optional[int] = None,
):
    """Build the train step.

    - With ``optimizer=``: ``step(params, opt_state, batch, rng) ->
      (params, opt_state, loss, aux)``.  The torch optimizer (over the same
      leaves) holds its own state and updates ``params`` in place;
      ``opt_state`` passes through.  On a mesh each leaf's gradient is
      reduced over the axes that hold a replica of it first (the module
      docstring), every rank applies the same update, and ``loss`` and
      ``aux`` are the global ones.  ``step.grads(params, batch, rng) ->
      (loss, aux)`` stops before the update.
    - With ``grad_spec=`` (needs ``mesh=``): ``step(params, batch, rng) ->
      (loss, aux, grads)`` with the global loss and aux, the hierarchical
      learner's in-mesh half.
      ``grad_spec`` is "replicated", "fsdp", "params" (mirror
      ``params_sharding``) or a tree of :class:`NamedSharding`; ``grads``
      is a tree of ``DTensor``s in that layout.
    - With ``overlap_grads=True``: ``step(params, batch, rng) -> (loss,
      aux, stream)``, ``stream`` a ``buckets.GradientStream`` fed from the
      backward's hooks (see the module docstring).  On a mesh the stream
      carries the gradients' shardings and lives on mesh rank 0, the
      host's Accumulator peer, which receives each run in full; the other
      ranks take part in the reductions and get ``None``.

    ``params_sharding`` ("replicated", "fsdp" or a tree) names the params'
    layout and decides the layout of ``grad_spec="params"``.  Parameters
    are whole over ``dp`` (FSDP is a layout of the reduced gradients); a
    model ``parallel.tensor_parallel.shard_model`` cut holds its ``tp``
    blocks, and ``ep``-sharded experts their block.
    ``batch_spec`` (default ``P(None, "dp")``) names the batch dims each
    rank takes its block of.
    """
    if grad_spec is not None and mesh is None:
        raise ValueError("grad_spec= requires mesh=")
    if overlap_grads and optimizer is not None:
        raise ValueError(
            "overlap_grads=True streams raw gradients to the caller; it does "
            "not compose with optimizer= (apply updates after the reduce)"
        )
    if overlap_grads and mesh is not None and grad_spec is None:
        raise ValueError("overlap_grads=True with mesh= requires grad_spec=")
    if grad_spec is None and optimizer is None and not overlap_grads:
        raise ValueError("make_train_step needs an optimizer unless grad_spec= is given")
    if isinstance(grad_spec, str) and grad_spec not in ("replicated", "fsdp", "params"):
        raise ValueError(
            f"unknown grad_spec {grad_spec!r} (expected 'replicated', 'fsdp', "
            "'params', or a sharding pytree)"
        )

    bspec = batch_spec if batch_spec is not None else P(None, "dp")
    red = _Reduction(mesh, params_sharding, bspec)
    if optimizer is not None:
        ostep = _optimizer_step(loss_fn, optimizer, mesh, red, bspec)
        timed = _instrument_step(ostep)
        timed.grads = ostep.grads
        return timed
    resolved: dict = {}

    def grad_shardings(params) -> list:
        if "gs" not in resolved:
            ps = params_sharding if params_sharding is not None else "replicated"
            gs = grad_spec
            if gs == "params":
                gs = ps
            if isinstance(gs, str):
                gs = param_shardings(params, mesh, gs)
            resolved["gs"] = nest.tree_leaves(gs)
        return resolved["gs"]

    def local_batch(batch):
        return _slice_batch(batch, mesh, bspec) if mesh is not None else batch

    def forward_backward(leaves, batch, rng, params):
        for p in leaves:
            p.grad = None
        loss, aux = loss_fn(params, local_batch(batch), rng)
        red.weigh(loss).backward()
        return loss.detach(), aux

    def zero_missing(leaves):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]

    if not overlap_grads:
        def sharded_grad_step(params, batch, rng):
            leaves, treedef = nest.tree_flatten(params)
            loss, aux = forward_backward(leaves, batch, rng, params)
            grads = _reduce_leaves(zero_missing(leaves), grad_shardings(params), red.n_tok,
                                   red.helds(params), red.axes(params))
            return red.global_mean(loss), nest.tree_map(red.global_mean, aux), \
                treedef.unflatten(grads)

        return _instrument_step(sharded_grad_step)

    return _instrument_step(_OverlapStep(forward_backward, mesh, red, grad_shardings))


class _OverlapStep:
    """The hook-streamed backward.  Hooks are registered once per params
    tree (on its leaves) and act only while this step's backward runs.
    ``log`` records each delivery of the last call: ``(lo, hi, in_backward,
    t_ns)``."""

    def __init__(self, forward_backward, mesh, red: _Reduction, grad_shardings):
        self._fb = forward_backward
        self._mesh = mesh
        self._red = red
        self._grad_shardings = grad_shardings
        self._lock = threading.Lock()
        self._leaves: Optional[list] = None
        self._handles: list = []
        self._call: Optional[dict] = None
        self.log: list = []

    def _install(self, leaves) -> None:
        for h in self._handles:
            h.remove()
        self._leaves = list(leaves)
        self._runs = _leaf_runs([p.numel() for p in leaves], leaves[0].element_size())
        self._run_of = {}
        for r, (lo, hi) in enumerate(self._runs):
            for i in range(lo, hi):
                self._run_of[i] = r
        self._handles = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: self._on_grad(i)) for i, p in enumerate(leaves)]

    def _on_grad(self, i: int) -> None:
        call = self._call
        if call is None:
            return  # a backward outside this step
        r = self._run_of[i]
        with self._lock:
            call["left"][r] -= 1
            ready = call["left"][r] == 0
        if ready:
            self._fire(call, r, in_backward=True)

    def _fire(self, call, r: int, in_backward: bool) -> None:
        lo, hi = self._runs[r]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._leaves[lo:hi]]
        if self._mesh is not None:
            red = self._red
            grads = gather_full(_reduce_leaves(
                grads, call["shardings"][lo:hi], red.n_tok, call["helds"][lo:hi],
                call["axes"][lo:hi]))
        call["fired"][r] = True
        # mtlint: allow-bare-timer(a delivery timestamp for the hook-order log, not a timed block)
        self.log.append((lo, hi, in_backward, time.perf_counter_ns()))
        if call["stream"] is not None:
            call["stream"].deliver(lo, grads)

    def __call__(self, params, batch, rng):
        leaves, treedef = nest.tree_flatten(params)
        if self._leaves is None or len(leaves) != len(self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            self._install(leaves)
        shardings = self._grad_shardings(params) if self._mesh is not None else None
        on_root = self._mesh is None or torch.distributed.get_rank() == mesh_ranks(self._mesh)[0]
        stream = None
        if on_root:
            shapes = ([tuple(p.shape) for p in leaves] if shardings is None else
                      [_full_shape(p.shape, sh, held)
                       for p, sh, held in zip(leaves, shardings, self._red.helds(params))])
            stream = buckets.GradientStream(treedef, shapes, [p.dtype for p in leaves],
                                            shardings=shardings)
        call = {"left": [hi - lo for lo, hi in self._runs], "fired": [False] * len(self._runs),
                "stream": stream, "shardings": shardings,
                "helds": self._red.helds(params), "axes": self._red.axes(params)}
        self.log = []
        self._call = call
        try:
            loss, aux = self._fb(leaves, batch, rng, params)
        except BaseException as e:
            if stream is not None:
                stream.fail(e)
            raise
        finally:
            self._call = None
        # Leaves the backward never reached (unused params) have zero
        # gradients; their runs go out now.
        for r, fired in enumerate(call["fired"]):
            if not fired:
                self._fire(call, r, in_backward=False)
        if self._mesh is not None:
            loss, aux = self._red.global_mean(loss), nest.tree_map(self._red.global_mean, aux)
        return loss, aux, stream
