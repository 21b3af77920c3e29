"""Mixture-of-Experts with expert parallelism (EP) over a mesh axis.

The port of the JAX package's ``parallel/moe.py``: Switch-style top-1
routing with a capacity factor.  Per rank (one process per mesh rank):

- Routing is global, as under JAX's ``jit``, where the flax module sees the
  whole token array.  The capacity is ``C = max(1, int(T / E * factor))``
  over the *global* token count ``T``, and a token's slot in its expert is
  its rank among the tokens routed to that expert in global order (batch
  rows first, then positions).  Each rank counts its tokens per row and
  expert, one ``all_gather`` over the token-sharding axes (``dp``, and
  ``sp`` where present) brings every rank's counts, and each token's global
  slot follows from the counts before it.  So the same tokens overflow as
  in JAX.  The aux loss (Switch Transformer eq. 4) is built from global
  means too.
- Experts shard over ``ep``: a rank holds ``[E/ep, D, F]`` of ``w_in`` and
  ``w_out`` (:func:`shard_experts`).  Tokens are replicated over ``ep``;
  each ``ep`` rank runs its experts on the group's tokens, and the combine
  is summed over ``ep`` (``collectives.psum``, under the package's
  gradient convention).

The expert products are plain matrix products (JAX computes them outside
any Pallas kernel): the kept tokens are copied into an ``[E/ep, C, D]``
slot buffer, the experts run as two batched matmuls, and each token reads
its slot back, scaled by its gate.  A slot holds one token, the experts
have no bias and ``relu(0) = 0``, so each token's output is the one JAX's
dense dispatch/combine einsums give.  No step syncs with the host.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import NamedSharding, PartitionSpec as P, axis_sizes, replicated

TOKEN_AXES = ("dp", "sp")


class SwitchMoE(nn.Module):
    """Top-1 routed MLP block: x [.., S, D] -> (y [.., S, D], aux).

    ``num_experts`` experts of hidden width ``ffn_dim``; per-expert slots
    ``C = max(1, int(T / E * capacity_factor))``; overflowing tokens fall
    through the residual (``residual=True``) or contribute zero
    (``residual=False``: the caller owns the skip connection).  Parameters
    are f32 (``router`` a Dense [D, E] with bias, ``w_in`` [E, D, F],
    ``w_out`` [E, F, D]); the experts compute in ``dtype``.
    """

    def __init__(self, d_model: int, num_experts: int, ffn_dim: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16,
                 residual: bool = True, device=None):
        super().__init__()
        from ..models.transformer import Dense

        self.num_experts, self.ffn_dim = num_experts, ffn_dim
        self.capacity_factor, self.dtype, self.residual = capacity_factor, dtype, residual
        self.router = Dense(d_model, num_experts, torch.float32, device)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, ffn_dim, device=device))
        self.w_out = nn.Parameter(torch.empty(num_experts, ffn_dim, d_model, device=device))

    def _expert_block(self, mesh, ep_axis: str) -> int:
        """Index of this rank's first expert (0 when it holds them all)."""
        e_loc = self.w_in.shape[0]
        if e_loc == self.num_experts:
            return 0
        ep = axis_sizes(mesh).get(ep_axis, 1) if mesh is not None else 1
        if ep * e_loc != self.num_experts:
            raise ValueError(f"SwitchMoE holds {e_loc} of {self.num_experts} experts; "
                             f"the mesh's {ep_axis} axis is {ep}")
        return mesh.get_local_rank(ep_axis) * e_loc

    def forward(self, x, mesh=None, ep_axis: str = "ep",
                token_axes: Tuple[str, ...] = TOKEN_AXES):
        from .collectives import psum

        orig_shape = x.shape
        D = x.shape[-1]
        rows = math.prod(orig_shape[:-2]) if x.ndim > 2 else 1
        x2 = x.reshape(-1, D)  # [N, D] this rank's tokens
        N = x2.shape[0]
        sizes = axis_sizes(mesh) if mesh is not None else {}
        tok_axes = tuple(a for a in token_axes if sizes.get(a, 1) > 1)
        T = N * math.prod(sizes[a] for a in tok_axes)
        E = self.num_experts
        C = max(1, int(T / E * self.capacity_factor))

        probs = torch.softmax(self.router(x2.to(torch.float32)), dim=-1)  # [N, E]
        gate, expert = probs.max(dim=-1)
        onehot = F.one_hot(expert, E)  # [N, E] int64
        counts = onehot.view(rows, N // rows, E).sum(1)  # [rows, E]
        before, total = self._global_counts(counts, mesh, tok_axes, rows)
        # 0-based slot: the tokens routed to the same expert before this
        # one, in global order.
        cum = onehot.view(rows, N // rows, E).cumsum(1) + before[:, None, :]
        pos = (cum.view(N, E) * onehot).sum(-1) - 1
        keep = pos < C

        e0 = self._expert_block(mesh, ep_axis)
        e_loc = self.w_in.shape[0]
        local = keep & (expert >= e0) & (expert < e0 + e_loc)
        dump = e_loc * C  # one spare slot takes every token not kept here
        slot = torch.where(local, (expert - e0) * C + pos, torch.full_like(pos, dump))
        xs = torch.zeros(dump + 1, D, dtype=self.dtype, device=x.device)
        xs = xs.index_copy(0, slot, x2.to(self.dtype))[:dump].view(e_loc, C, D)
        h = torch.relu(torch.bmm(xs, self.w_in.to(self.dtype)))
        ys = torch.bmm(h, self.w_out.to(self.dtype)).view(dump, D)
        ys = torch.cat([ys, torch.zeros(1, D, dtype=ys.dtype, device=ys.device)])
        out = (gate.to(self.dtype)[:, None] * ys.index_select(0, slot)).to(x.dtype)
        if e_loc < E:
            out = psum(out, ep_axis, mesh)

        # Load-balancing loss (Switch Transformer eq. 4), global means.
        density = total.to(torch.float32) / T
        proxy = psum(probs.sum(0), tok_axes, mesh) / T
        aux = E * torch.sum(density * proxy)
        out = out.reshape(orig_shape)
        # Tokens over capacity in this call, over the whole token group (a
        # device tensor: reading it syncs, so only callers that report do).
        self.last_dropped = (total - C).clamp_min(0).sum()
        return (x + out, aux) if self.residual else (out, aux)

    def _global_counts(self, counts, mesh, tok_axes, rows):
        """``(before, total)``: for each local row, each expert's tokens in
        every earlier position of the global order (earlier rows, and this
        row's earlier sequence chunks), [rows, E]; and each expert's global
        count, [E]."""
        if not tok_axes:
            return counts.cumsum(0) - counts, counts.sum(0)
        from .collectives import _back, _on_host_backend, _to_host, axes_group

        group, coords = axes_group(mesh, tok_axes)
        sizes = axis_sizes(mesh)
        n_dp = sizes.get("dp", 1) if "dp" in tok_axes else 1
        n_sp = sizes.get("sp", 1) if "sp" in tok_axes else 1
        E = counts.shape[1]
        shape = (len(coords) * rows, E)  # every rank's counts, in group order
        if _on_host_backend(counts, group):
            host = torch.empty(shape, dtype=counts.dtype, pin_memory=True)
            dist.all_gather_into_tensor(host, _to_host(counts.contiguous()), group=group)
            gathered = _back(host, counts)
        else:
            gathered = torch.empty(shape, dtype=counts.dtype, device=counts.device)
            dist.all_gather_into_tensor(gathered, counts.contiguous(), group=group)
        gathered = gathered.view(len(coords), rows, E)
        grid = torch.zeros(n_dp, rows, n_sp, E, dtype=counts.dtype, device=counts.device)
        for i, c in enumerate(coords):
            grid[c.get("dp", 0), :, c.get("sp", 0)] = gathered[i]
        flat = grid.view(-1, E)
        before_all = flat.cumsum(0) - flat  # exclusive, global order
        me_dp = mesh.get_local_rank("dp") if "dp" in tok_axes else 0
        me_sp = mesh.get_local_rank("sp") if "sp" in tok_axes else 0
        idx = (me_dp * rows + torch.arange(rows, device=counts.device)) * n_sp + me_sp
        return before_all[idx], flat.sum(0)


def shard_experts(model: nn.Module, mesh, ep_axis: str = "ep") -> None:
    """Cut every :class:`SwitchMoE` of ``model`` to this rank's experts:
    ``w_in``/``w_out`` become ``[E/ep, ...]`` parameters holding the rank's
    block (``collectives.shard_of``).  Build the optimizer afterwards."""
    from .collectives import shard_of

    sh = NamedSharding(mesh, P(ep_axis, None, None))
    for mod in model.modules():
        if isinstance(mod, SwitchMoE) and mod.w_in.shape[0] == mod.num_experts:
            with torch.no_grad():
                mod.w_in = nn.Parameter(shard_of(mod.w_in, sh).clone())
                mod.w_out = nn.Parameter(shard_of(mod.w_out, sh).clone())


def moe_param_spec(ep_axis: str = "ep"):
    """PartitionSpecs for SwitchMoE params: experts sharded over ``ep_axis``."""
    return {
        "router": {"kernel": P(), "bias": P()},
        "w_in": P(ep_axis, None, None),
        "w_out": P(ep_axis, None, None),
    }


def moe_shardings(params, mesh, ep_axis: str = "ep", base: Optional[Any] = None):
    """:class:`NamedSharding`s for a whole model's parameters (a dict of
    name -> tensor, e.g. ``dict(model.named_parameters())`` of the unsharded
    model): expert weights (leaves named ``w_in``/``w_out`` with a leading
    expert axis divisible by the ``ep_axis`` size) shard over ``ep_axis``;
    everything else gets ``base`` (default: replicated), one sharding or a
    dict matching ``params``."""
    if base is None:
        base = replicated(mesh)
    ep = axis_sizes(mesh)[ep_axis]
    out = {}
    for name, x in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w_in", "w_out") and x.ndim == 3 and x.shape[0] % ep == 0:
            out[name] = NamedSharding(mesh, P(ep_axis, None, None))
        else:
            out[name] = base if isinstance(base, NamedSharding) else base[name]
    return out
