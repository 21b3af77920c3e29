"""Batched LM generation served over RPC — inference batching
(``define_queue(dynamic_batching=True)``) applied to the TransformerLM.

A server peer owns the model and a dynamic-batching queue: concurrent
single-prompt calls from many client peers are stacked into one batch, run
through :func:`..models.transformer.generate` (flash prefill on the card,
then KV-cache decoding) and unbatched back to each caller.

Serve:  python -m moolib_tpu_torch.examples.lm_serve --listen 127.0.0.1:4460

Clients are any Rpc peer calling ``generate`` on the server's name with a
1-D int32 prompt — a ``moolib_tpu`` peer as well as a ``moolib_tpu_torch``
one, the wire being shared.  Prompts in one batch must share a length (the
queue stacks them); pad client-side for mixed lengths.

This slice ports the plain ``--listen`` server.  The client mode, the
broker-registered replicas, weight hot-swap, the continuous-batching engine
and tensor-parallel serving come with later slices and exit with a message.
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from .._device import resolve
from ..models.transformer import TransformerLM, generate
from ..rpc import Rpc
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

    def gen(prompts: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = generate(model, torch.from_numpy(prompts), max_new_tokens)
            return out.cpu().numpy().astype(prompts.dtype, copy=False)

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


_NOT_PORTED = ("connect", "broker", "broker_addrs", "publisher", "engine", "mesh")


def main(argv=None):
    p = argparse.ArgumentParser(description="batched LM generation over RPC")
    p.add_argument("--listen", default=None, help="serve on this address")
    p.add_argument("--name", default="lm_server", help="this server's peer name")
    for flag in _NOT_PORTED:
        p.add_argument(f"--{flag}", default=None, help="not yet ported (a later slice)")
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--no_dynamic_batching", action="store_true",
                   help="serve one call per iteration")
    flags = p.parse_args(argv)
    given = [f"--{f}" for f in _NOT_PORTED if getattr(flags, f) not in (None, "")]
    if given:
        raise SystemExit(
            f"{', '.join(given)}: not yet ported to moolib_tpu_torch "
            "(this slice serves the plain --listen path)"
        )
    if flags.listen is None:
        raise SystemExit("pass --listen")
    device = resolve(flags.device)
    telemetry.init_from_env()
    model = make_model(flags, device, torch.Generator().manual_seed(flags.seed))
    rpc = Rpc()
    rpc.set_name(flags.name)
    rpc.listen(flags.listen)
    try:
        loop = serve(
            rpc, model, flags.max_new_tokens,
            batch_size=flags.batch_size,
            dynamic_batching=not flags.no_dynamic_batching,
            warm_seq_len=flags.seq_len,
        )
        print(f"serving 'generate' on {flags.listen} [device={device}]", flush=True)
        asyncio.run(loop)
    finally:
        rpc.close()


if __name__ == "__main__":
    main()
