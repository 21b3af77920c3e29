"""The fleet soaks: end-to-end resilience gates over real processes.

Each module is the port of the JAX package's script of the same name under
``scripts/`` and runs as ``python -m moolib_tpu_torch.scripts.<name>``:

- ``broker_soak``: the primary broker SIGKILLed mid-allreduce and mid-serve;
- ``serve_soak``: a replica SIGKILLed and a live hot-swap under load
  (``--engine``: through the continuous-batching engine; ``--swing``: the
  autoscaled fleet under a load swing);
- ``chaos_soak``: EnvPool supervision, the elastic LM under RPC frame
  faults, forced-kill resume from the newest intact checkpoint, and a
  mid-shard-write kill under distributed checkpoints;
- ``autoscale_soak``: the autoscaler's fleet of elastic LM workers under
  Poisson preemption and a graceful decommission;
- ``replay_smoke``: memfd-multicast ingest and the two-level cohort draw
  across a process boundary.

Every soak takes ``--device``: without it each child runs on the card (a
missing card raises), ``--device cpu`` runs them on the CPU.  A failed
gate exits non-zero.
"""
