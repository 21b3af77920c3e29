"""Batched LM generation served over RPC — inference batching
(``define_queue(dynamic_batching=True)``) applied to the TransformerLM: the
port of the JAX package's ``examples/lm_serve.py``.

A server peer owns the model and a dynamic-batching queue: concurrent
single-prompt calls from many client peers are stacked into one batch, run
through :func:`..models.transformer.generate` (the model's own attention for
the prefill, then KV-cache decoding) and unbatched back to each caller.

Serve:  python -m moolib_tpu_torch.examples.lm_serve --listen 127.0.0.1:4460
Client: python -m moolib_tpu_torch.examples.lm_serve --connect 127.0.0.1:4460 \\
            --prompts 3 (sends 3 concurrent prompts, prints continuations)

The resilient tier (``moolib_tpu_torch.serving``) layers on top: start N
servers with ``--broker`` (each registers as a non-contributing cohort
observer and subscribes to ``--publisher`` for zero-downtime weight
hot-swap), and point clients at the broker instead of a replica — they
discover the fleet, spread load, and retry idempotently across replica
deaths:

Broker:   python -m moolib_tpu_torch.broker --address 127.0.0.1:4431
Replica:  python -m moolib_tpu_torch.examples.lm_serve --listen 127.0.0.1:4460 \\
              --broker 127.0.0.1:4431 --name replica0 [--publisher pusher] [--engine]
Client:   python -m moolib_tpu_torch.examples.lm_serve --broker 127.0.0.1:4431

``--connect`` stays the single-shot, no-retry baseline against one server;
``--broker_addrs a,b`` names a primary broker and its hot standbys.
``--engine`` swaps the batch-synchronous replica plane for the
continuous-batching engine (``moolib_tpu_torch.engine``): decode slots over
a paged KV pool, per-request token budgets (clients pass ``max_new`` as the
second positional argument), admission in per-token units — the same broker
registration, hot-swap and stats surface.  Without ``--engine`` a replica
still honours per-request budgets, but decodes each batch to its row
maximum.  The wire is the JAX package's: either package's clients, replicas,
brokers and publishers mix.  Prompts in one batch of the plain server must
share a length (the queue stacks them); pad client-side for mixed lengths.

Servers run on CUDA unless ``--device`` names another device.
``--mesh`` and ``--prefill_devices`` (tensor-parallel serving) exit "not
yet ported (slice 9)"; ``--localdir`` (the autoscaler's decommission flag)
exits "not yet ported (slice 7)".
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from .._device import resolve
from ..models.transformer import TransformerLM, generate
from ..rpc import Rpc
from ..utils import create_uid
from ..serving import bucket as _bucket
from ..serving import bucket_shapes as _bucket_shapes

_M_BATCH_RETRY = telemetry.get_registry().counter(
    "serve_batch_retries_total",
    "failed batches retried unbatched (blast-radius isolation)",
)


def make_model(flags, device=None, generator: Optional[torch.Generator] = None):
    return TransformerLM(
        vocab_size=flags.vocab,
        d_model=flags.d_model,
        num_heads=flags.heads,
        num_kv_heads=getattr(flags, "kv_heads", 0) or None,
        num_layers=flags.layers,
        attention="dense",
        dtype=torch.float32,
        pos_embedding="rotary",
        max_len=flags.seq_len + flags.max_new_tokens,
        device=device,
        generator=generator,
    )


def _generate_np(model: TransformerLM, prompts: np.ndarray, max_new: int) -> np.ndarray:
    """:func:`generate` on the model's device, numpy prompts in and numpy
    replies (in the prompts' dtype) out."""
    with torch.inference_mode():
        out = generate(model, torch.from_numpy(prompts), max_new)
        return out.cpu().numpy().astype(prompts.dtype, copy=False)


def serve(rpc: Rpc, model: TransformerLM, max_new_tokens: int, *, name: str = "generate",
          batch_size: int = 16, total=None, dynamic_batching: bool = True,
          warm_seq_len: Optional[int] = None):
    """Coroutine serving ``total`` prompts (None = forever).  Returns the
    number of *service iterations* — with concurrent callers this is smaller
    than the prompt count, which is the point of dynamic batching.

    The model runs where its weights are (the card, for a model built with
    the default device).  Replies are numpy arrays in the prompts' dtype.
    Dynamic batches are padded to the next power-of-two bucket (capped at
    ``batch_size``), the JAX package's policy, so both servers see the same
    batch shapes.  ``dynamic_batching`` off serves one call per iteration.
    """
    queue = rpc.define_queue(
        name,
        batch_size=batch_size if dynamic_batching else None,
        dynamic_batching=dynamic_batching,
    )
    counters = {"served": 0, "iterations": 0, "bucket_pad_rows": 0,
                "batch_retries": 0}
    rpc.define(f"{name}_stats", lambda: {**queue.stats(), **counters,
                                         "batch_size": batch_size if dynamic_batching else 1})

    gen = functools.partial(_generate_np, model, max_new=max_new_tokens)

    if warm_seq_len is not None:
        shapes = _bucket_shapes(batch_size) if dynamic_batching else [1]
        for b in shapes:
            gen(np.zeros((b, warm_seq_len), np.int32))

    async def loop():
        served = iterations = 0
        while total is None or served < total:
            ret_cb, args, kwargs = await queue
            prompts = np.asarray(args[0])
            single = prompts.ndim == 1
            if single:
                prompts = prompts[None]
            n = prompts.shape[0]
            served += n
            iterations += 1
            counters["served"], counters["iterations"] = served, iterations
            if dynamic_batching and n < batch_size:
                bucket = _bucket(n, batch_size)
                if n < bucket:
                    pad = np.repeat(prompts[-1:], bucket - n, axis=0)
                    batch = np.concatenate([prompts, pad], axis=0)
                else:
                    batch = prompts
                counters["bucket_pad_rows"] += bucket - n
            else:
                batch = prompts
            try:
                out = gen(batch)[:n]
            except Exception as e:  # noqa: BLE001 — fail small, keep serving
                rets = getattr(ret_cb, "rets", None)
                if rets is None:
                    # Single caller: the failure is already its own.
                    ret_cb.error(f"generate failed: {e}")
                    continue
                # Blast-radius isolation: one poisoned prompt must not error
                # every caller stacked into its batch — retry once unbatched
                # (row i belongs to caller i) so only the offender fails.
                counters["batch_retries"] += 1
                _M_BATCH_RETRY.inc()
                for i, ret in enumerate(rets):
                    try:
                        row = gen(prompts[i][None])[0]
                    except Exception as e2:  # noqa: BLE001
                        ret.error(f"generate failed: {e2}")
                        continue
                    ret(row)
                continue
            ret_cb(out[0] if single else out)
        return iterations

    return loop()


def _unported(flags) -> list:
    """(flag, slice) for every flag set to a path this slice does not port."""
    found = []
    if flags.mesh:
        found.append(("--mesh", 9))
    if flags.prefill_devices:
        found.append(("--prefill_devices", 9))
    if flags.localdir:
        found.append(("--localdir", 7))
    return found


def _replica(flags, rpc, model, broker_list):
    """The resilient batch-synchronous replica: admission control, request
    dedup and hot-swap staging (``serving.ServeReplica``) over
    :func:`generate`, with the same bucket policy and warm-up as
    :func:`serve`.  Per-request budgets ride as the step's third argument;
    each batch decodes to its row-max budget, bucketed.  A staged version's
    weights load into the model once, at its first batch."""
    from .. import serving as serving_mod
    from ..models.convert import as_state_dict

    loaded = [None]  # the payload the model's weights came from (None: the seed's)

    def step(p_, batch, budgets=None):
        if p_ is not loaded[0]:
            with torch.no_grad():
                model.load_state_dict(as_state_dict(p_))
            loaded[0] = p_
        if flags.service_delay_ms > 0:
            time.sleep(flags.service_delay_ms / 1e3)
        mn = flags.max_new_tokens if budgets is None else int(np.max(budgets))
        return _generate_np(model, np.asarray(batch), _bucket(mn, flags.max_new_tokens))

    shapes = _bucket_shapes(flags.batch_size) if not flags.no_dynamic_batching else [1]
    for b in shapes:
        _generate_np(model, np.zeros((b, flags.seq_len), np.int32), flags.max_new_tokens)
    return serving_mod.ServeReplica(
        rpc, step, None,
        name="generate",
        batch_size=flags.batch_size,
        dynamic_batching=not flags.no_dynamic_batching,
        max_queue=flags.max_queue,
        broker=broker_list[0] if broker_list else None,
        brokers=broker_list[1:],
        broker_name=flags.broker_name,
        group=flags.group,
        publisher=flags.publisher,
        model_channel=flags.model_channel,
        per_request_tokens=True,
        default_max_new=flags.max_new_tokens,
    )


def _engine_replica(flags, rpc, model, broker_list):
    """The continuous-batching arm: slots over a paged KV pool under the
    same ServeService contract (``engine.EngineService``).  ``warmup()`` runs
    every prefill bucket and the decode step before the readiness line."""
    from .. import serving as serving_mod
    from ..engine import ContinuousBatchingEngine, EngineService

    engine = ContinuousBatchingEngine(
        model, slots=flags.slots or flags.batch_size, block_size=flags.block_size,
        max_prompt_len=flags.seq_len,
    )
    engine.warmup()
    if flags.service_delay_ms > 0:
        _eng_step = engine.step

        def _slow_step():
            time.sleep(flags.service_delay_ms / 1e3)
            return _eng_step()

        engine.step = _slow_step
    service = EngineService(rpc, engine, name="generate", max_queue=flags.max_queue,
                            default_max_new=flags.max_new_tokens)
    return serving_mod.ServeReplica(
        rpc, None, None, name="generate", service=service,
        broker=broker_list[0] if broker_list else None,
        brokers=broker_list[1:],
        broker_name=flags.broker_name,
        group=flags.group,
        publisher=flags.publisher,
        model_channel=flags.model_channel,
    )


def _client(flags, broker_list) -> None:
    from .. import serving as serving_mod

    rpc = Rpc()
    # A name of its own per run: ServeClient's request ids are
    # "<name>:<counter>", and a replica answers a repeated id from its
    # done-cache (dedup, 60 s), so a second run under a fixed name would get
    # the first run's replies back.
    rpc.set_name(f"lm_client-{create_uid()[:8]}")
    try:
        if flags.connect:
            # Single-shot baseline: one static server, no retries, no
            # metadata (works against the plain serve() queue).
            rpc.connect(flags.connect)
            client = serving_mod.ServeClient(
                rpc, fn="generate", replicas=[flags.name],
                deadline_s=flags.deadline_s, max_attempts=1, metadata=False,
            )
        else:
            # Resilient path: broker discovery, load spreading, idempotent
            # retry with capped exponential backoff across replica deaths.
            client = serving_mod.ServeClient(
                rpc, fn="generate", broker=broker_list[0], brokers=broker_list[1:],
                broker_name=flags.broker_name, group=flags.group,
                deadline_s=flags.deadline_s,
            )
            client.wait_for_replicas(1, timeout=flags.deadline_s)
        try:
            rng = np.random.default_rng(flags.seed + 1)
            futs = []
            for _ in range(flags.prompts):
                prompt = rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32)
                futs.append((prompt, client.submit(prompt)))
            for prompt, fut in futs:
                out = np.asarray(fut.result(flags.deadline_s + 5.0))
                print(f"prompt={prompt.tolist()}\n  -> {out[len(prompt):].tolist()}", flush=True)
        finally:
            client.close()
    finally:
        rpc.close()


def main(argv=None):
    p = argparse.ArgumentParser(description="batched LM generation over RPC")
    p.add_argument("--listen", default=None, help="serve on this address")
    p.add_argument("--connect", default=None,
                   help="request from this address (single-shot, no-retry "
                   "baseline against one server)")
    p.add_argument("--broker", default=None,
                   help="broker address: with --listen, register this server "
                   "as a serving replica (non-contributing cohort observer, "
                   "ServeClient-discoverable); without --listen, run the "
                   "resilient client (replica discovery + retry + failover)")
    p.add_argument("--broker_addrs", default=None,
                   help="comma-separated broker addresses (primary + hot "
                   "standbys): like --broker but replicas and clients fail "
                   "over across the list; supersedes --broker")
    p.add_argument("--broker_name", default="broker")
    p.add_argument("--group", default="serve",
                   help="broker group replicas register in / clients discover from")
    p.add_argument("--name", default="lm_server",
                   help="this server's peer name (replicas need unique names; "
                   "--connect clients call this name)")
    p.add_argument("--publisher", default=None,
                   help="server: subscribe to this peer's ModelPublisher for "
                   "zero-downtime weight hot-swap")
    p.add_argument("--model_channel", default="model",
                   help="publisher endpoint prefix under --publisher")
    p.add_argument("--max_queue", type=int, default=128,
                   help="replica admission-queue bound (requests beyond it are "
                   "rejected immediately with a typed overload error)")
    p.add_argument("--deadline_s", type=float, default=30.0,
                   help="client per-request deadline budget (replicas reject "
                   "requests that cannot meet it)")
    p.add_argument("--prompts", type=int, default=3, help="concurrent client prompts")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seq_len", type=int, default=16)
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query attention (0 = heads)")
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=16,
                   help="dynamic-batching cap: batches pad to power-of-two buckets")
    p.add_argument("--mesh", default="", help="tensor-parallel serving (not yet ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--no_dynamic_batching", action="store_true",
                   help="serve one call per iteration")
    p.add_argument("--engine", action="store_true",
                   help="serve with the continuous-batching engine (paged KV "
                   "cache, per-request budgets, no convoy)")
    p.add_argument("--slots", type=int, default=0,
                   help="engine decode slots (0 = --batch_size)")
    p.add_argument("--block_size", type=int, default=16,
                   help="engine KV pool block size in tokens")
    p.add_argument("--prefill_devices", type=int, default=0,
                   help="disaggregated prefill over a mesh (not yet ported)")
    p.add_argument("--service_delay_ms", type=float, default=0.0,
                   help="add this many milliseconds to every service iteration "
                   "(a load-testing hook that makes saturation deterministic)")
    p.add_argument("--localdir", default=None,
                   help="the autoscaler's decommission flag directory (not yet ported)")
    flags = p.parse_args(argv)
    unported = _unported(flags)
    if unported:
        raise SystemExit("; ".join(f"{f}: not yet ported (slice {n})" for f, n in unported))
    # One broker list everywhere below: --broker_addrs (HA) wins, --broker
    # stays as the single-address alias.
    broker_list = [a.strip() for a in (flags.broker_addrs or "").split(",") if a.strip()]
    if not broker_list and flags.broker:
        broker_list = [flags.broker]
    if flags.listen is None and (flags.connect is None) == (not broker_list):
        raise SystemExit("pass --listen, --connect, or --broker/--broker_addrs (client mode)")
    if flags.listen is not None and flags.connect is not None:
        raise SystemExit("--listen and --connect are mutually exclusive")
    if flags.listen is None:
        _client(flags, broker_list)
        return
    device = resolve(flags.device)
    telemetry.init_from_env()
    model = make_model(flags, device, torch.Generator().manual_seed(flags.seed))
    rpc = Rpc()
    rpc.set_name(flags.name)
    rpc.listen(flags.listen)
    replica = None
    try:
        # Every shape is run BEFORE the readiness line: clients arriving at
        # "serving" never queue behind a warm-up.  Harnesses key on both
        # lines ("be patient" against "never came up").
        if flags.engine:
            nbuckets = len(set(_bucket_shapes(flags.seq_len))) + 1
        elif flags.no_dynamic_batching:
            nbuckets = 1
        else:
            nbuckets = len(_bucket_shapes(flags.batch_size))
        print(f"precompiling {nbuckets} bucket shape(s) [device={device}]", flush=True)
        if flags.engine:
            replica = _engine_replica(flags, rpc, model, broker_list)
            loop = replica.loop()
        elif broker_list or flags.publisher:
            replica = _replica(flags, rpc, model, broker_list)
            loop = replica.loop()
        else:
            loop = serve(
                rpc, model, flags.max_new_tokens,
                batch_size=flags.batch_size,
                dynamic_batching=not flags.no_dynamic_batching,
                warm_seq_len=flags.seq_len,
            )
        print(f"serving 'generate' on {flags.listen} [device={device}]", flush=True)
        asyncio.run(loop)
    finally:
        if replica is not None:
            replica.close()
        rpc.close()


if __name__ == "__main__":
    main()
