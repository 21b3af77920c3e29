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

``grad_spec=`` on a ``dp`` x ``tp`` mesh (the vtrace learner's
``--mesh dp=N,tp=M``) reduces the same way into the ``auto_shardings``
layout: a leaf sharded over ``dp`` and ``tp`` comes back as a ``DTensor``
with two ``Shard`` placements.  Other model-parallel axes inside the
elastic cohort (``grad_spec=`` with ``sp``/``ep``/``pp``, and
``overlap_grads=`` on any model-parallel axis) are not yet ported
(slice 9e).
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
                   replicated)

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


def _model_parallel_axes(mesh) -> List[str]:
    return [k for k, v in axis_sizes(mesh).items() if k != "dp" and v > 1]


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


def _optimizer_step(loss_fn, optimizer, mesh, params_sharding, batch_spec):
    """The step with an optimizer, on any mesh or none (see the module
    docstring): ``step(params, opt_state, batch, rng) -> (params,
    opt_state, loss, aux)`` with the global loss and aux.
    ``step.grads(params, batch, rng) -> (loss, aux)`` runs the same forward,
    backward and reduction and leaves the reduced gradients in the leaves'
    ``.grad``, without the update (a warm-up or a probe)."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    live = [a for a, n in sizes.items() if n > 1]
    tok_axes = [a for a in live if a in _spec_axes(batch_spec)]
    n_tok = int(np.prod([sizes[a] for a in tok_axes])) if tok_axes else 1
    n_rep = int(np.prod([sizes[a] for a in live])) // n_tok
    resolved: dict = {}

    def reduce_axes(params) -> list:
        """Per leaf (flatten order): the axes its gradient is summed over."""
        if "axes" not in resolved:
            leaves = nest.tree_leaves(params)
            if params_sharding is None or params_sharding == "replicated":
                shs = [None] * len(leaves)
            else:
                shs = nest.tree_leaves(params_sharding)
            resolved["axes"] = [tuple(a for a in live if a not in _held_axes(p, sh))
                                for p, sh in zip(leaves, shs)]
        return resolved["axes"]

    def global_mean(x):
        if not isinstance(x, torch.Tensor) or not live:
            return x
        return _all_reduce(x.detach().to(torch.float32) / n_rep,
                           axes_group(mesh, tuple(live))[0]) / n_tok

    def grads(params, batch, rng):
        leaves = nest.tree_leaves(params)
        for p in leaves:
            p.grad = None
        if mesh is not None:
            batch = _slice_batch(batch, mesh, batch_spec)
        loss, aux = loss_fn(params, batch, rng)
        (loss / n_rep if n_rep > 1 else loss).backward()
        axes = reduce_axes(params)
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for (ax, _), idx in _groups(range(len(leaves)), lambda i: (axes[i], gs[i].dtype)):
            if not ax and n_tok == 1:
                continue
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            if ax:
                flat = _all_reduce(flat, axes_group(mesh, ax)[0])
            flat = flat.div_(n_tok)
            off = 0
            for i in idx:
                leaves[i].grad = flat[off:off + gs[i].numel()].view(gs[i].shape)
                off += gs[i].numel()
        return global_mean(loss.detach()), nest.tree_map(global_mean, aux)

    def step(params, opt_state, batch, rng):
        loss, aux = grads(params, batch, rng)
        optimizer.step()
        return params, opt_state, loss, aux

    step.grads = grads
    return step


def fsdp_spec(x, axis: str = "dp", min_size: int = 2**16) -> P:
    """ZeRO-3-style spec: shard the largest divisible axis of big params."""
    shape = tuple(x.shape)
    if not shape or int(np.prod(shape)) < min_size:
        return P()
    best = max(range(len(shape)), key=lambda i: shape[i])
    spec = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def param_shardings(params, mesh, mode: str = "replicated", axis: str = "dp"):
    """Tree of :class:`NamedSharding` for the params: "replicated" (pure DP)
    or "fsdp" (largest-axis sharding for big leaves)."""
    if mode == "replicated":
        return nest.tree_map(lambda _: replicated(mesh), params)
    if mode == "fsdp":
        sizes = axis_sizes(mesh)

        def spec_of(x):
            s = fsdp_spec(x, axis)
            # Only keep the sharding if the axis divides evenly.
            for dim, name in zip(x.shape, s):
                if name is not None and dim % sizes[name]:
                    return replicated(mesh)
            return NamedSharding(mesh, s)

        return nest.tree_map(spec_of, params)
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
                   helds: Optional[List[set]] = None) -> list:
    """The dp-mean of gradient leaves, each in its target sharding's layout,
    as DTensors.  ``grads`` are the leaves' local gradients: whole, or the
    block of the axes ``helds[i]`` their parameter is cut over (a ``tp``
    block), which must be among the target's.  Per leaf: one all-reduce
    over the axes that hold a replica of it and that the target does not
    scatter; its block of the target's other model-parallel axes; and,
    where the target shards it over ``dp``, one reduce-scatter of the
    blocks packed rank-major (each rank keeps its block of every leaf).
    One collective per group of leaves that share those axes and a
    dtype."""
    mesh = shardings[0].mesh
    sizes = axis_sizes(mesh)
    live = [a for a, k in sizes.items() if k > 1]
    helds = helds if helds is not None else [set()] * len(grads)
    full_shapes, scatter, sums = [], [], []
    for g, sh, held in zip(grads, shardings, helds):
        axes = _spec_axes(sh.spec)
        if not held <= axes:
            raise ValueError(f"a gradient held over {sorted(held)} cannot take the layout {sh!r}")
        shape = list(g.shape)
        for a, d in sh.hits():
            if a in held:
                shape[d] *= sizes[a]
        full_shapes.append(tuple(shape))
        scatter.append("dp" in axes and sizes.get("dp", 1) > 1)
        sums.append(tuple(a for a in live if a not in held and not (a == "dp" and "dp" in axes)))
    out: list = [None] * len(grads)
    red: list = [None] * len(grads)
    for (ax, _), idx in _groups(range(len(grads)), lambda i: (sums[i], grads[i].dtype)):
        if not ax:
            for i in idx:
                red[i] = grads[i]
            continue
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                           axes_group(mesh, ax)[0])
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
            flat = reduce_scatter_axis(_pack([red[i] for i in idx], dims, n), "dp", mesh)
            locals_ = _unpack_block(flat.div_(n), [red[i] for i in idx], dims, n)
        else:
            locals_ = [red[i] / n if n > 1 else red[i] for i in idx]
        for i, local in zip(idx, locals_):
            out[i] = _dtensor(local, shardings[i], full_shapes[i])
    return out


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
      (loss, aux, grads)``, the hierarchical learner's in-mesh half.
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
    mp_axes = _model_parallel_axes(mesh) if mesh is not None else []
    cohort_mp = [a for a in mp_axes if a != "tp" or overlap_grads]
    if cohort_mp and (grad_spec is not None or overlap_grads):
        raise NotImplementedError(
            f"mesh axes {cohort_mp} inside the elastic cohort (grad_spec=, "
            "overlap_grads=): not yet ported (slice 9e)")
    if isinstance(grad_spec, str) and grad_spec not in ("replicated", "fsdp", "params"):
        raise ValueError(
            f"unknown grad_spec {grad_spec!r} (expected 'replicated', 'fsdp', "
            "'params', or a sharding pytree)"
        )

    n_dp = axis_sizes(mesh).get("dp", 1) if mesh is not None else 1
    bspec = batch_spec if batch_spec is not None else P(None, "dp")
    if optimizer is not None:
        ostep = _optimizer_step(loss_fn, optimizer, mesh, params_sharding, bspec)
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

    # Ranks of a tp group hold the same tokens: each weighs its loss by
    # one over the group (the gradient convention of parallel.collectives).
    n_tp = axis_sizes(mesh).get("tp", 1) if mesh is not None else 1

    def forward_backward(leaves, batch, rng, params):
        for p in leaves:
            p.grad = None
        loss, aux = loss_fn(params, local_batch(batch), rng)
        (loss / n_tp if n_tp > 1 else loss).backward()
        return loss.detach(), aux

    def zero_missing(leaves):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]

    if not overlap_grads:
        def sharded_grad_step(params, batch, rng):
            leaves, treedef = nest.tree_flatten(params)
            loss, aux = forward_backward(leaves, batch, rng, params)
            shs = grad_shardings(params)
            helds = [_held_axes(p, None) for p in leaves]
            grads = _reduce_leaves(zero_missing(leaves), shs, n_dp, helds)
            return loss, aux, treedef.unflatten(grads)

        return _instrument_step(sharded_grad_step)

    return _instrument_step(_OverlapStep(forward_backward, mesh, n_dp, grad_shardings))


class _OverlapStep:
    """The hook-streamed backward.  Hooks are registered once per params
    tree (on its leaves) and act only while this step's backward runs.
    ``log`` records each delivery of the last call: ``(lo, hi, in_backward,
    t_ns)``."""

    def __init__(self, forward_backward, mesh, n_dp, grad_shardings):
        self._fb = forward_backward
        self._mesh = mesh
        self._n = n_dp
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
            shs = call["shardings"][lo:hi]
            grads = gather_full(_reduce_leaves(grads, shs, self._n))
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
        on_root = self._mesh is None or self._mesh.get_local_rank("dp") == 0
        stream = None
        if on_root:
            stream = buckets.GradientStream(
                treedef, [tuple(p.shape) for p in leaves], [p.dtype for p in leaves],
                shardings=shardings)
        call = {"left": [hi - lo for lo, hi in self._runs], "fired": [False] * len(self._runs),
                "stream": stream, "shardings": shardings}
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
        return loss, aux, stream
