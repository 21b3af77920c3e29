"""Recovery-phase accounting: ONE histogram family for every kind of
come-back the stack performs (docs/RESILIENCE.md "Recovery budget").

The soak's headline number — seconds from a peer's kill to its first fresh
contribution — is useless for *fixing* slow recovery unless it decomposes
into phases with separate owners and knobs.  Every recovery path in the
stack therefore observes into the same labeled histogram::

    recovery_seconds{phase=...}

Phases (the peer-rejoin chain tiles the restart timeline end to end):

- ``reconnect``          — process start (Accumulator construction) to the
  first membership epoch that includes this peer (broker dial + first push).
- ``re_elect``           — membership epoch change to the election result
  (observed every epoch: elections are a per-churn cost, not just restart).
- ``model_sync``         — election result to ``epoch_synced`` on a
  non-leader (chunked model transfer, or the warm-rejoin fast path).
- ``first_compile``      — first sync to the train loop's first gradient
  contribution call (dominated by XLA compile of the grad step; the
  persistent compile cache exists to shrink exactly this bar).
- ``first_contribution`` — that first contribution call to the first
  applied cohort gradient result (the peer is productive again).
- ``worker_respawn``     — EnvPool supervisor: worker death detected to the
  respawned slot re-attached with its unfinished steps re-issued
  (:meth:`moolib_tpu_torch.envpool.EnvPool._supervise_dead_worker`).
- ``broker_failover``    — a peer's broker pings going silent (or answered
  by a demoted standby) to the first successful ping against the NEW
  primary after the failover scan picked it (``Group.set_brokers``, which
  the port has not yet).

Buckets span 50 ms (same-host respawn) to 5 min (cold jax start on a
loaded box) — wider than the default latency buckets because recovery is a
seconds-scale phenomenon by design.
"""

from __future__ import annotations

from .metrics import Histogram, get_registry

__all__ = ["RECOVERY_BUCKETS", "RECOVERY_PHASES", "observe_phase", "recovery_histogram"]

RECOVERY_PHASES = (
    "reconnect",
    "re_elect",
    "model_sync",
    "first_compile",
    "first_contribution",
    "worker_respawn",
    "broker_failover",
)

RECOVERY_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 40.0, 60.0, 120.0, 300.0,
)


def recovery_histogram() -> Histogram:
    """The process-wide ``recovery_seconds`` family (idempotent)."""
    return get_registry().histogram(
        "recovery_seconds",
        "seconds spent per recovery phase (peer rejoin, worker respawn)",
        ("phase",),
        buckets=RECOVERY_BUCKETS,
    )


def observe_phase(phase: str, seconds: float) -> None:
    """Record one phase duration.  ``phase`` should come from
    :data:`RECOVERY_PHASES` (new phases are allowed but must be documented
    in docs/TELEMETRY.md)."""
    recovery_histogram().observe(float(seconds), phase=phase)
