"""Pipeline parallelism: GPipe and circular (interleaved) schedules over a
``pp`` mesh axis.

The port of the JAX package's ``parallel/pipeline.py``, per rank: every
``pp`` rank runs the same tick loop, holds its stages' parameters, and
hands activations round the ring once per tick (S = pipeline ranks, M =
microbatches, v = ``circular_repeats``):

- ``circular_repeats=1`` (GPipe): one stage per rank, ``M + S - 1`` ticks;
- ``circular_repeats=v``: ``L = v*S`` virtual stages laid round-robin over
  the ring (layer ``j`` runs on rank ``j % S`` during lap ``j // S``), so each
  microbatch laps the ring ``v`` times in ``v*M + S - 1`` ticks.

JAX's tick schedule and layer-to-rank map are kept.  A bubble tick (no valid
microbatch at this rank) computes nothing here, where JAX computes and masks
it, but every rank still makes the tick's ring hop, so sends and receives
pair up.  After the last tick the final stage's outputs are summed over
``pp`` (JAX's ``psum``), so every ``pp`` rank returns them.

The schedule is one autograd node (:class:`_Pipeline`).  Its forward keeps
each valid tick's small graph (the stage's input as a leaf, its output);
its backward walks the ticks in reverse, makes the reverse hop of every
tick on every rank in the same order, and back-propagates each tick's
stage with ``torch.autograd.grad``.  So no rank waits on a hop another rank
skips, whatever the autograd engine's order elsewhere.  ``remat=True``
wraps each stage in ``torch.utils.checkpoint`` (``remat_policy`` as the
model's ``REMAT_POLICIES``): the stage's activations are recomputed in the
backward.  Gradients follow the package's convention
(``parallel.collectives``): the outputs' sum over ``pp`` takes a sum in the
backward, and a rank's parameter gradients cover only the stages it runs
(zeros for the others).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from ..utils import nest
from .mesh import axis_sizes


def _stage_leaves(item) -> list:
    if isinstance(item, nn.Module):
        return [p for p in item.parameters() if p.requires_grad]
    return [x for x in nest.tree_leaves(item) if isinstance(x, torch.Tensor)]


class _Schedule:
    """The tick schedule of one ``pipeline_apply`` call on this rank."""

    def __init__(self, S: int, V: int, M: int, stage: int):
        self.S, self.V, self.M, self.stage = S, V, M, stage
        self.n_ticks = V * M + S - 1

    def tick(self, i: int):
        """``(valid, lap, microbatch)`` of tick ``i`` on this rank."""
        S, V, M = self.S, self.V, self.M
        t = i - self.stage
        u = t % (S * V)
        r = u // S
        m = min(max((t // (S * V)) * S + u % S, 0), M - 1)
        return 0 <= t < V * M, r, m


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, xs, *params):
        from .collectives import RingExchange, _all_reduce

        sched, run = plan["schedule"], plan["run"]
        S, V = sched.S, sched.V
        hop = RingExchange(plan["axis_name"], plan["mesh"])
        outs = torch.zeros_like(xs)
        carry = torch.zeros_like(xs[0])
        saved = {}
        for i in range(sched.n_ticks):
            valid, r, m = sched.tick(i)
            y = torch.zeros_like(carry)
            if valid:
                from_xs = sched.stage == 0 and r == 0
                x_in = (xs[m] if from_xs else carry).detach().requires_grad_(plan["grad"])
                with torch.set_grad_enabled(plan["grad"]):
                    out = run(r * S + sched.stage, x_in)
                if plan["grad"]:
                    saved[i] = (x_in, out, r * S + sched.stage, from_xs, m)
                y = out.detach()
                if sched.stage == S - 1 and r == V - 1:
                    outs[m] = y
            hop.start(hop.stage(y))
            carry = hop.wait(y.device)[0]
        if sched.stage != S - 1:
            outs.zero_()
        ctx.plan, ctx.saved = plan, saved
        return _all_reduce(outs, hop.group) if S > 1 else outs

    @staticmethod
    def backward(ctx, g_outs):
        from .collectives import RingExchange, _all_reduce

        plan, saved = ctx.plan, ctx.saved
        sched = plan["schedule"]
        S, V = sched.S, sched.V
        params = plan["params"]
        index = {id(p): k for k, p in enumerate(params)}
        hop = RingExchange(plan["axis_name"], plan["mesh"], shift=-1)
        if S > 1:
            g_outs = _all_reduce(g_outs.contiguous(), hop.group)
        g_xs = torch.zeros_like(g_outs)
        g_params: list = [None] * len(params)
        g_carry = torch.zeros_like(g_outs[0])  # the last tick's hop is unused
        for i in reversed(range(sched.n_ticks)):
            # Forward: carry_{i+1} = hop(y_i).  Backward: y_i's gradient
            # comes back from the rank the hop sent it to.
            hop.start(hop.stage(g_carry))
            g_y = hop.wait(g_carry.device)[0]
            g_carry = torch.zeros_like(g_y)
            if i not in saved:
                continue  # a bubble tick: its output fed nothing
            x_in, out, j, from_xs, m = saved.pop(i)
            valid, r, _ = sched.tick(i)
            if sched.stage == S - 1 and r == V - 1:
                g_y = g_y + g_outs[m]
            leaves = plan["leaves"][j]
            grads = torch.autograd.grad(out, [x_in] + leaves, g_y, allow_unused=True)
            for p, g in zip(leaves, grads[1:]):
                if g is None:
                    continue
                k = index[id(p)]
                g_params[k] = g if g_params[k] is None else g_params[k] + g
            if from_xs:
                g_xs[m] += grads[0]
            else:
                g_carry = grads[0]
        # Zeros for the stages this rank does not run: every rank's
        # parameters then take a gradient from this node, so the leaves'
        # hooks fire alike on every rank (parallel.train's overlap step).
        g_params = [torch.zeros_like(p) if g is None and p.requires_grad else g
                    for p, g in zip(params, g_params)]
        return (None, g_xs, *g_params)


def pipeline_apply(
    stage_fn: Callable,
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh,
    axis_name: str = "pp",
    data_axis: Optional[str] = None,
    circular_repeats: int = 1,
    remat: bool = False,
    remat_policy: Optional[str] = None,
):
    """Run ``y_m = stage_{L-1}(... stage_0(x_m))`` for every microbatch.

    Args:
      stage_fn: ``stage_fn(params_for_one_stage, x) -> y`` with x and y of
        the same shape.
      stage_params: the ``L = circular_repeats * S`` stages in execution
        order: a sequence of L items (each an ``nn.Module`` or a tree of
        tensors), or a tree whose leaves have a leading axis of size L
        (JAX's layout; stage ``j`` gets the leaves' ``[j]``).  Stage ``j``
        runs on ``pp`` rank ``j % S`` during lap ``j // S``.
      microbatches: [M, B, ...], this rank's microbatches.  With
        ``data_axis`` the batch dim (axis 1) is this rank's block of it (the
        ranks of ``data_axis`` each stream their own); the pipeline's hops
        and sums run over ``axis_name`` only.  With ``circular_repeats > 1``
        M must be a multiple of S.
      circular_repeats: virtual stages per rank (``v``); 1 = GPipe.
      remat, remat_policy: rematerialise each stage in the backward
        (``torch.utils.checkpoint``); the policy ("full" or None, "dots",
        "dots_no_batch") names what is saved.

    Returns [M, B, ...] outputs of the final stage, on every ``pp`` rank.
    Every rank of the ``pp`` group calls it (and runs its backward) in the
    same order.
    """
    from ..models.transformer import REMAT_POLICIES, remat_call

    sizes = axis_sizes(mesh)
    S = sizes[axis_name]
    if data_axis is not None and data_axis not in sizes:
        raise ValueError(f"data_axis {data_axis!r} is not an axis of the mesh")
    V = circular_repeats
    M = microbatches.shape[0]
    if V > 1 and M % S:
        raise ValueError(f"circular schedule needs microbatches % pp == 0, got {M} % {S}")
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        stages = list(stage_params)
        L = len(stages)
    else:
        L = nest.tree_leaves(stage_params)[0].shape[0]
        stages = None
    if L != V * S:
        raise ValueError(
            f"stage_params leading axis is {L}, need circular_repeats*pp = {V * S}"
        )
    policy = remat_policy or "full"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {'|'.join(REMAT_POLICIES)}, "
                         f"got {remat_policy!r}")
    stage = mesh.get_local_rank(axis_name)
    if stages is not None:
        leaves = [_stage_leaves(st) for st in stages]
        params = [p for ls in leaves for p in ls]

        def run(j, x):
            return remat_call(stage_fn, (stages[j], x), remat, policy)
    else:
        params = [x for x in nest.tree_leaves(stage_params) if isinstance(x, torch.Tensor)]
        leaves = [params] * L

        def run(j, x):
            p_j = nest.tree_map(lambda p: p[j], stage_params)
            return remat_call(stage_fn, (p_j, x), remat, policy)
    grad = torch.is_grad_enabled() and (microbatches.requires_grad
                                        or any(p.requires_grad for p in params))
    plan = {"schedule": _Schedule(S, V, M, stage), "run": run, "mesh": mesh,
            "axis_name": axis_name, "params": params, "leaves": leaves, "grad": grad}
    return _Pipeline.apply(plan, microbatches, *params)
