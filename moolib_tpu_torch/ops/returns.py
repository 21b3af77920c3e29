"""Return/advantage estimators and the policy-gradient loss terms.

The port of the JAX package's ``ops/returns.py``: the n-step discounted
return (the reference A2C loss inputs, ``examples/a2c.py:121-164``), GAE,
the entropy loss and the per-step cross entropy.  Each reverse
``lax.scan`` becomes a reversed Python loop over T that writes into a
preallocated [T, B] tensor (T small kernels: the recurrence is sequential
in time and elementwise over B); ``stop_gradient`` is ``.detach()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def discounted_returns(
    rewards: torch.Tensor, discounts: torch.Tensor, bootstrap_value: torch.Tensor
) -> torch.Tensor:
    """R_t = r_t + gamma_t * R_{t+1}, time-major [T, B]."""
    out = torch.empty_like(rewards)
    acc = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = rewards[t] + discounts[t] * acc
        out[t] = acc
    return out


def generalized_advantage_estimation(
    rewards: torch.Tensor,
    values: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    lambda_: float = 0.95,
):
    """GAE(lambda); returns (advantages, value_targets), time-major [T, B],
    both detached."""
    values_t1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + discounts * values_t1 - values
    advantages = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * lambda_ * acc
        advantages[t] = acc
    return advantages.detach(), (advantages + values).detach()


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Negative mean policy entropy (minimized => maximises entropy)."""
    logp = F.log_softmax(logits, dim=-1)
    return torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def softmax_cross_entropy(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """-log pi(a|s), elementwise (policy-gradient building block)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, actions[..., None].long()).squeeze(-1)
