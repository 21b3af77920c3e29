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

Tensor-parallel serving: ``--mesh tp=N`` with ``--listen`` (the plain
batch-synchronous server, the path the JAX package gives ``--mesh``) runs N
rank processes: this one spawns ranks 1..N-1 (or all N run under
``torchrun``).  Every rank holds its ``tp`` blocks of the model
(``models.transformer.sharded_generator``); rank 0 owns the Rpc queue and
the bucket padding and, for each batch, broadcasts one command and the
padded prompts; every rank runs the sharded generate; rank 0 replies.
``--mesh`` with ``--engine`` or the resilient replica keeps the JAX
meaning: those paths do not shard, but for the engine's disaggregated
prefill: ``--engine --mesh dp=W --prefill_devices N`` runs W rank
processes, the first N prefill and the rest decode
(``engine.ContinuousBatchingEngine(mesh=, prefill_devices=)``); this
process is the first decode rank and owns the Rpc queue and the slots, and
spawns the others (or all W run under ``torchrun``).  With ``--localdir`` a
serving replica watches the autoscaler's decommission flag there and
leaves when it appears.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel, telemetry
from .._device import resolve
from ..models.transformer import TransformerLM, generate, sharded_generator
from ..rpc import Rpc
from ..utils import create_uid
from ..serving import bucket as _bucket
from ..serving import bucket_shapes as _bucket_shapes

_M_BATCH_RETRY = telemetry.get_registry().counter(
    "serve_batch_retries_total",
    "failed batches retried unbatched (blast-radius isolation)",
)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_model(flags, device=None, generator: Optional[torch.Generator] = None):
    return TransformerLM(
        vocab_size=flags.vocab,
        d_model=flags.d_model,
        num_heads=flags.heads,
        num_kv_heads=getattr(flags, "kv_heads", 0) or None,
        num_layers=flags.layers,
        attention=getattr(flags, "attention", "dense"),
        dtype=_DTYPES[getattr(flags, "dtype", "float32")],
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


# Rank 0 of a tensor-parallel server to its other ranks (MeshControl).
_GENERATE, _STOP = 1, 2


class _MeshGenerate:
    """:func:`_generate_np` over a tensor-parallel mesh, on rank 0: one
    command and one broadcast of the (padded) prompts to every rank, then
    the sharded generate, which every rank runs (:func:`follow`)."""

    def __init__(self, model: TransformerLM, max_new_tokens: int, mesh):
        from .common import MeshControl

        self.model, self.mesh = model, mesh
        self.axes = tuple(mesh.mesh_dim_names)
        self.control = MeshControl(mesh, model.device, axes=self.axes)
        self.fn = sharded_generator(model, max_new_tokens, mesh)

    def __call__(self, prompts: np.ndarray) -> np.ndarray:
        self.control.send(_GENERATE)
        batch = parallel.broadcast_tree(torch.from_numpy(prompts).to(self.model.device),
                                        self.mesh, self.model.device, axis_name=self.axes)
        with torch.inference_mode():
            out = self.fn(batch)
        return out.cpu().numpy().astype(prompts.dtype, copy=False)

    def stop(self) -> None:
        """Release the other ranks (once; moot after the process group is
        gone: an interrupted server's host has killed them)."""
        import torch.distributed as dist

        if dist.is_initialized() and self.control is not None:
            self.control.send(_STOP)
        self.control = None


def follow(model: TransformerLM, max_new_tokens: int, mesh) -> int:
    """The loop of a tensor-parallel server's ranks other than 0: run the
    sharded generate on every batch rank 0 broadcasts until it says stop.
    Returns the batches run.  A batch that fails (a prompt out of the
    vocabulary fails on every rank alike) is rank 0's to report."""
    from .common import MeshControl

    axes = tuple(mesh.mesh_dim_names)
    control = MeshControl(mesh, model.device, axes=axes)
    fn = sharded_generator(model, max_new_tokens, mesh)
    n = 0
    while control.receive()[0] == _GENERATE:
        batch = parallel.broadcast_tree(None, mesh, model.device, axis_name=axes)
        try:
            with torch.inference_mode():
                fn(batch)
        except Exception:  # noqa: BLE001 — rank 0 replies with the error
            pass
        n += 1
    return n


def serve(rpc: Rpc, model: TransformerLM, max_new_tokens: int, *, name: str = "generate",
          batch_size: int = 16, total=None, mesh=None, dynamic_batching: bool = True,
          warm_seq_len: Optional[int] = None):
    """Coroutine serving ``total`` prompts (None = forever).  Returns the
    number of *service iterations* — with concurrent callers this is smaller
    than the prompt count, which is the point of dynamic batching.

    The model runs where its weights are (the card, for a model built with
    the default device).  Replies are numpy arrays in the prompts' dtype.
    Dynamic batches are padded to the next power-of-two bucket (capped at
    ``batch_size``), the JAX package's policy, so both servers see the same
    batch shapes.  ``dynamic_batching`` off serves one call per iteration.

    ``mesh``: serve tensor-parallel, on mesh rank 0, while every other rank
    runs :func:`follow` on its copy of the model (the same weights): the
    model is cut to this rank's ``tp`` blocks (``auto_shardings``), so one
    server peer fronts a model larger than one card's memory.  When the
    coroutine ends (``total`` served, or cancelled) it releases the other
    ranks.
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

    if mesh is not None:
        gen = _MeshGenerate(model, max_new_tokens, mesh)
    else:
        gen = functools.partial(_generate_np, model, max_new=max_new_tokens)

    if warm_seq_len is not None:
        shapes = _bucket_shapes(batch_size) if dynamic_batching else [1]
        for b in shapes:
            gen(np.zeros((b, warm_seq_len), np.int32))

    async def loop():
        try:
            return await _loop()
        finally:
            if mesh is not None:
                gen.stop()

    async def _loop():
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


async def _serve_until_decommissioned(loop, localdir, replica, rpc):
    """Run the service coroutine ``loop``; with ``localdir``, a watcher
    thread polls the autoscaler's decommission flag there and, when it
    appears, drains the service (``replica.close()``: queued requests get
    typed errors and the broker sees an explicit leave; a plain server
    closes its Rpc) and ends the coroutine, so the process exits."""
    task = asyncio.ensure_future(loop)
    if not localdir:
        return await task
    import threading

    from ..autoscaler import decommission_requested

    aloop = asyncio.get_running_loop()
    leaving = threading.Event()

    def _watch():
        while not task.done():
            if decommission_requested(localdir):
                print("decommission requested; leaving", flush=True)
                leaving.set()
                if replica is not None:
                    replica.close()
                else:
                    rpc.close()
                aloop.call_soon_threadsafe(task.cancel)
                return
            time.sleep(0.5)

    threading.Thread(target=_watch, name="decommission-watch", daemon=True).start()
    try:
        return await task
    except asyncio.CancelledError:
        if not leaving.is_set():
            raise
        return None


def _split_engine(flags) -> bool:
    """``--engine --mesh ... --prefill_devices N``: disaggregated prefill."""
    return bool(flags.engine and flags.mesh and flags.prefill_devices)


def _owner_rank(flags) -> int:
    """The rank that owns the Rpc queue: rank 0 of a tensor-parallel
    server, the first decode rank of a split engine."""
    return flags.prefill_devices if _split_engine(flags) else 0


def _mesh_world(flags) -> int:
    """Rank processes of a sharded server (0: none): ``--mesh`` on the
    plain server (tensor parallel), or on the engine with
    ``--prefill_devices`` (a split engine: prefill ranks, then decode
    ranks); the engine alone and the resilient replica do not shard (the
    JAX package's meaning)."""
    axes = parallel.mesh.parse_axes(flags.mesh)
    if axes and flags.listen is not None and _split_engine(flags):
        if any(v == -1 for v in axes.values()):
            raise ValueError("--prefill_devices needs every --mesh axis's size")
        parallel.split_mesh(axes, flags.prefill_devices)  # the JAX package's errors
        return math.prod(axes.values())
    if not axes or flags.listen is None or flags.engine or flags.broker or \
            flags.broker_addrs or flags.publisher:
        return 0
    if any(v == -1 for v in axes.values()):
        import os

        if "WORLD_SIZE" not in os.environ:
            raise ValueError("--mesh with a -1 axis needs the world size: start the "
                             "ranks with torchrun, or give every axis its size")
        world = int(os.environ["WORLD_SIZE"])
        parallel.mesh.mesh_axes(axes, world)  # the JAX package's mesh errors
        return world
    return math.prod(axes.values())


def _mesh_rank(flags, coordinator, world: int, rank):
    """Join the server's process group; returns ``(mesh, model, device)``:
    every rank builds the seed's whole model, then serving cuts it."""
    device = resolve(flags.device)
    parallel.initialize_distributed(coordinator, world if coordinator else None, rank,
                                    device=device)
    mesh = parallel.parse_mesh_spec(flags.mesh, device_type=device.type)
    device = resolve(flags.device)  # the card the rank was bound to
    return mesh, make_model(flags, device, torch.Generator().manual_seed(flags.seed)), device


def _follow_main(flags) -> None:
    """A rank of a sharded server other than the one that owns the Rpc
    queue: a tensor-parallel rank, or a split engine's prefill (or other
    decode) rank, serving the owner's commands until it closes."""
    import torch.distributed as dist

    mesh, model, _ = _mesh_rank(flags, None, _mesh_world(flags), None)
    try:
        if _split_engine(flags):
            _make_engine(flags, model, mesh).follow()
        else:
            follow(model, flags.max_new_tokens, mesh)
    finally:
        dist.destroy_process_group()


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


def _make_engine(flags, model, mesh=None):
    """The engine of every rank (collectively when split)."""
    from ..engine import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        model, slots=flags.slots or flags.batch_size, block_size=flags.block_size,
        max_prompt_len=flags.seq_len, mesh=mesh, prefill_devices=flags.prefill_devices,
    )


def _engine_replica(flags, rpc, model, broker_list, mesh=None):
    """The continuous-batching arm: slots over a paged KV pool under the
    same ServeService contract (``engine.EngineService``).  ``warmup()`` runs
    every prefill bucket and the decode step before the readiness line.
    Returns the replica and its engine."""
    from .. import serving as serving_mod
    from ..engine import EngineService

    engine = _make_engine(flags, model, mesh)
    engine.warmup()
    # Count the kernels of served requests only, as from here (the exit
    # line sets them beside the engine's prefills).
    from ..ops import flash_attention as fa

    fa.reset_launches()
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
    ), engine


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
    from .common import mesh_flags_from_env

    spawned = mesh_flags_from_env()
    if spawned is not None:  # a rank 1..N-1 of a tensor-parallel server
        _follow_main(spawned)
        return
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
    p.add_argument("--attention", default="dense", choices=["dense", "flash"],
                   help="the model's attention: flash runs the prefill on the flash kernel")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                   help="the model's compute dtype")
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=16,
                   help="dynamic-batching cap: batches pad to power-of-two buckets")
    p.add_argument("--mesh", default="",
                   help='serve tensor-parallel over these axes, e.g. "tp=4": that many '
                   "rank processes (server side only; params cut to auto_shardings)")
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
                   help="with --engine and --mesh: disaggregated prefill on the first N "
                   "mesh ranks; the rest decode, and this process is the first decode "
                   "rank (it spawns the others unless torchrun started them)")
    p.add_argument("--service_delay_ms", type=float, default=0.0,
                   help="add this many milliseconds to every service iteration "
                   "(a load-testing hook that makes saturation deterministic)")
    p.add_argument("--localdir", default=None,
                   help="per-replica scratch dir: the autoscaler's decommission "
                   "flag is polled here")
    flags = p.parse_args(argv)
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
    world = _mesh_world(flags)
    if world:
        import os

        if int(os.environ.get("RANK", _owner_rank(flags))) != _owner_rank(flags):
            _follow_main(flags)  # under torchrun: not the Rpc owner
            return
        _serve_mesh(flags, world, broker_list)
        return
    device = resolve(flags.device)
    telemetry.init_from_env()
    model = make_model(flags, device, torch.Generator().manual_seed(flags.seed))
    _serve_main(flags, model, device, broker_list)


def _serve_mesh(flags, world: int, broker_list=()) -> None:
    """The Rpc owner of a sharded server (rank 0 of a tensor-parallel
    server, the first decode rank of a split engine): spawn the other
    ranks unless ``torchrun`` started them, serve, then release and join
    them."""
    import os

    import torch.distributed as dist

    from ..utils.config import Config
    from .common import spawn_mesh_ranks

    children = []
    coordinator = None
    if "RANK" not in os.environ:
        coordinator, children = spawn_mesh_ranks(
            "moolib_tpu_torch.examples.lm_serve", Config(vars(flags)), world,
            host_rank=_owner_rank(flags))
    try:
        mesh, model, device = _mesh_rank(flags, coordinator, world,
                                         None if "RANK" in os.environ else _owner_rank(flags))
        telemetry.init_from_env()
        _serve_main(flags, model, device, list(broker_list), mesh=mesh)
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for c in children:
        if c.wait(timeout=600) != 0:
            raise RuntimeError(f"lm_serve: a mesh rank exited with {c.returncode}")


def _serve_main(flags, model, device, broker_list, mesh=None) -> None:
    rpc = Rpc()
    rpc.set_name(flags.name)
    rpc.listen(flags.listen)
    replica = engine = None
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
            replica, engine = _engine_replica(flags, rpc, model, broker_list, mesh=mesh)
            loop = replica.loop()
        elif broker_list or flags.publisher:
            replica = _replica(flags, rpc, model, broker_list)
            loop = replica.loop()
        else:
            loop = serve(
                rpc, model, flags.max_new_tokens, mesh=mesh,
                batch_size=flags.batch_size,
                dynamic_batching=not flags.no_dynamic_batching,
                warm_seq_len=flags.seq_len,
            )
        print(f"serving 'generate' on {flags.listen} [device={device}]", flush=True)
        asyncio.run(_serve_until_decommissioned(loop, flags.localdir, replica, rpc))
    finally:
        if replica is not None:
            replica.close()
        if engine is not None:
            engine.close()  # a split engine's other ranks leave follow()
        rpc.close()
        _print_launches(engine)


def _print_launches(engine) -> None:
    """The exit line a soak reads: each flash kernel's launches in this
    process, with the engine's prefills (counted from its warm-up on)."""
    import json

    from ..ops import flash_attention as fa

    launches = fa.launch_counts()
    if engine is not None:
        launches["prefills"] = engine.stats()["joins"]
    print(f"kernel_launches: {json.dumps(launches)}", flush=True)


if __name__ == "__main__":
    main()
