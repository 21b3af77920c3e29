"""V-trace off-policy actor-critic targets (IMPALA).

The port of the JAX package's ``ops/vtrace.py`` (reference
``examples/common/vtrace.py:50-242``, from deepmind/scalable_agent,
Espeholt et al. 2018).  Its reverse ``lax.scan`` over time becomes a
reversed Python loop over T writing into a preallocated [T, B] tensor.

Conventions: time-major tensors ``[T, B]`` (``[T, B, A]`` for logits),
``bootstrap_value`` ``[B]``; the returned targets are detached (constants
with respect to the learner's parameters).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VTraceReturns(NamedTuple):
    vs: torch.Tensor  # [T, B] value targets
    pg_advantages: torch.Tensor  # [T, B] policy-gradient advantages


class VTraceFromLogitsReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor
    log_rhos: torch.Tensor
    behavior_action_log_probs: torch.Tensor
    target_action_log_probs: torch.Tensor


def action_log_probs(policy_logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|s) from logits [..., A] and integer actions [...]."""
    logp = F.log_softmax(policy_logits, dim=-1)
    return torch.gather(logp, -1, actions[..., None].long()).squeeze(-1)


@torch.no_grad()
def from_importance_weights(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: float = 1.0,
    clip_pg_rho_threshold: float = 1.0,
    lambda_: float = 1.0,
) -> VTraceReturns:
    """Core v-trace recursion (reference ``from_importance_weights``).
    Under ``no_grad``: both outputs are targets."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = lambda_ * torch.clamp(rhos, max=1.0)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    vs_minus_v_xs = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v_xs[t] = acc
    vs = values + vs_minus_v_xs

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold)
    pg_advantages = clipped_pg_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)


def from_logits(
    behavior_policy_logits: torch.Tensor,
    target_policy_logits: torch.Tensor,
    actions: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: float = 1.0,
    clip_pg_rho_threshold: float = 1.0,
    lambda_: float = 1.0,
) -> VTraceFromLogitsReturns:
    """V-trace from behavior/target logits (reference ``from_logits``)."""
    behavior_log_probs = action_log_probs(behavior_policy_logits, actions)
    target_log_probs = action_log_probs(target_policy_logits, actions)
    log_rhos = target_log_probs - behavior_log_probs
    vt = from_importance_weights(
        log_rhos,
        discounts,
        rewards,
        values,
        bootstrap_value,
        clip_rho_threshold,
        clip_pg_rho_threshold,
        lambda_,
    )
    return VTraceFromLogitsReturns(
        vs=vt.vs,
        pg_advantages=vt.pg_advantages,
        log_rhos=log_rhos,
        behavior_action_log_probs=behavior_log_probs,
        target_action_log_probs=target_log_probs,
    )
