"""Tensor parallelism over a ``tp`` mesh axis.

The JAX package has no tensor-parallel module: it places the parameters on
``parallel.auto_shardings`` (``tp`` on the output features of every big
kernel) and XLA's GSPMD propagates that layout through the program,
inserting the collectives.  This module is the port's counterpart of what
GSPMD inserts for that layout; it has no JAX twin.

Layout.  :func:`shard_model` cuts every ``Dense``, ``Embed`` and ImpalaNet
``Conv`` whose kernel the layout splits over ``tp`` to this rank's block
of output features: ``Dense`` ``[in, out]`` (the LM's projections and its
``lm_head`` ``[D, V]``) on ``out``, ``Embed`` ``[V, D]`` on ``D``, a conv
``[out, in, kh, kw]`` on ``out``.  The block replaces the parameter, so a
rank holds 1/tp of each such kernel; :func:`tp_named` gives the model's
parameters as ``DTensor``s over the mesh (the blocks, no copy) and
:func:`as_dtensors` wraps gradients or moments of the same layout.  Biases
and LayerNorm parameters are 1-D: ``auto_shardings`` replicates them, and
a sharded layer adds its slice of its bias.  The ``dp`` part of the layout
does not cut parameters (they are whole over ``dp``); it is the layout
``parallel.make_train_step(grad_spec=)`` reduces gradients into.  Leaves
of modules without a tensor-parallel form (an LSTM's packed kernels, MoE
experts) stay whole and compute replicated.

Compute.  A sharded layer computes only its own output features and
:func:`gather` all-gathers them over ``tp``.  The LM block
(``models.transformer.Block``) splits attention by heads: after the qkv
gather each rank takes its H/tp query heads and Hk/tp KV heads through
``ops.flash_attention`` (the hand-written kernels) and gathers the
heads' outputs; Dense_0 applies its GELU to its 4D/tp local features
before the gather.  Where H or Hk is not a multiple of tp, every rank
attends over all heads.  The decode cache holds the rank's KV heads.

Gradient convention (``parallel.collectives``).  Ranks of a ``tp`` group
hold the same tokens, so each weighs its loss by 1/tp and the gradient it
holds for a replicated value is a partial share.  :func:`gather`'s
backward is the transpose of the all-gather, JAX's ``psum_scatter``: the
group's partial gradients summed (Megatron's *g*, a sum over ``tp``, in
the backward), this rank keeping its slice.  So a block's gradient is
whole (the step does not reduce it over ``tp``), and Megatron's *f*, the
replicated input entering a rank-local product, needs no collective of
its own: its partial gradients are summed with the replicated leaves' at
the end of the step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .collectives import _dtensor, all_gather_axis, reduce_scatter_axis, shard_of
from .mesh import NamedSharding, PartitionSpec as P, axis_sizes, layout_dims


class TPShard:
    """A layer's place on the ``tp`` axis: the mesh, the axis, its size and
    this rank's index."""

    __slots__ = ("mesh", "axis", "n", "rank")

    def __init__(self, mesh, axis: str = "tp"):
        self.mesh, self.axis = mesh, axis
        self.n = axis_sizes(mesh)[axis]
        self.rank = mesh.get_local_rank(axis)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return gather(x, self.mesh, self.axis, dim)

    def local(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's slice of a replicated ``x`` along ``dim``."""
        return x.chunk(self.n, dim=dim)[self.rank]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather_axis(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return reduce_scatter_axis(g, axis, mesh, dim), None, None, None


def gather(x: torch.Tensor, mesh, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """Every ``axis`` rank's ``x`` concatenated along ``dim`` (rank order).
    Differentiable: the backward sums the ranks' gradients and keeps this
    rank's slice (see the module docstring)."""
    if axis_sizes(mesh).get(axis, 1) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.ndim)


def _layers(model: nn.Module):
    """``(name prefix, module, kernel attribute, output dim)`` of every layer
    with a tensor-parallel form."""
    from ..models.impala import Conv
    from ..models.transformer import Dense, Embed

    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, Dense):
            yield prefix, mod, "kernel", 1
        elif isinstance(mod, Embed):
            yield prefix, mod, "embedding", 1
        elif isinstance(mod, Conv):
            yield prefix, mod, "kernel", 0


def shard_model(model: nn.Module, mesh, shardings=None, axis: str = "tp") -> Dict[str, NamedSharding]:
    """Cut ``model`` to this rank's ``axis`` blocks in place (see the module
    docstring) and return the shardings of the parameters it holds: each
    cut leaf's over ``axis`` alone, with the whole model's shape in
    ``model.tp_full_shapes``.  ``shardings`` (default ``auto_shardings``
    over the model's whole parameters) names the layout; its ``dp``
    entries cut nothing.  Build the optimizer afterwards.  Idempotent."""
    from .train import auto_shardings

    if getattr(model, "tp_shardings", None) is not None:
        return model.tp_shardings
    named = dict(model.named_parameters())
    if shardings is None:
        shardings = auto_shardings(named, mesh, tp_axis=axis)
    sizes = axis_sizes(mesh)
    held: Dict[str, NamedSharding] = {}
    full_shapes = {k: tuple(p.shape) for k, p in named.items()}
    shard = TPShard(mesh, axis) if sizes.get(axis, 1) > 1 else None
    for prefix, mod, attr, out_dim in _layers(model):
        key = prefix + attr
        sh = shardings.get(key)
        dims = [d for a, d in (sh.hits() if sh is not None else []) if a == axis]
        if shard is None or not dims:
            continue
        if dims != [out_dim]:
            raise ValueError(f"{key}: the layout splits tensor dim {dims} over {axis}; "
                             f"a {type(mod).__name__} computes its dim {out_dim} apart")
        p = getattr(mod, attr)
        spec = [None] * p.ndim
        spec[out_dim] = axis
        dims4 = layout_dims(tuple(p.shape))
        own = NamedSharding(mesh, P(*(spec if dims4 is None else [spec[d] for d in dims4])),
                            dims4)
        with torch.no_grad():
            block = nn.Parameter(shard_of(p.detach(), own).clone(), requires_grad=p.requires_grad)
        block.tp_sharding = own
        setattr(mod, attr, block)
        mod.tp = shard
        held[key] = own
    from ..models.transformer import Block, TransformerLM

    for mod in model.modules():
        if isinstance(mod, (Block, TransformerLM)) and shard is not None:
            mod.tp = shard
    model.tp_shardings = held
    model.tp_full_shapes = full_shapes
    return held


def tp_named(model: nn.Module) -> dict:
    """The model's parameters by name, the cut ones as ``DTensor``s over
    the mesh (views of the blocks)."""
    return as_dtensors(model, dict(model.named_parameters()))


def as_dtensors(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (named like the model's parameters, each of its
    parameter's local shape: gradients, moments) with the cut leaves as
    ``DTensor``s of the whole model's shape; the rest pass through."""
    held = getattr(model, "tp_shardings", None) or {}
    return {k: (_dtensor(v, held[k], model.tp_full_shapes[k]) if k in held and v is not None
                else v) for k, v in tensors.items()}


def held_sharding(p: torch.Tensor) -> Optional[NamedSharding]:
    """The sharding a parameter cut by :func:`shard_model` is held in."""
    return getattr(p, "tp_sharding", None)


def param_bytes(model: nn.Module) -> dict:
    """This rank's parameter bytes: ``{"sharded", "replicated", "total"}``
    and ``"whole"``, the bytes of the uncut model."""
    held = getattr(model, "tp_shardings", None) or {}
    full = getattr(model, "tp_full_shapes", None) or {}
    out = {"sharded": 0, "replicated": 0, "whole": 0}
    for k, p in model.named_parameters():
        nb = p.numel() * p.element_size()
        out["sharded" if k in held else "replicated"] += nb
        n_full = 1
        for d in full.get(k, p.shape):
            n_full *= int(d)
        out["whole"] += n_full * p.element_size()
    out["total"] = out["sharded"] + out["replicated"]
    return out
