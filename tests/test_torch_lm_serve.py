"""The port's LM server against the JAX package's generate(), token for
token: concurrent single-prompt Rpc calls stack into one dynamic batch, run
the port's KV-cache generate() on weights converted from the flax init, and
each caller's reply equals JAX generate() on the same prompt (greedy)."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.examples import lm_serve as jax_lm_serve
from moolib_tpu.models.transformer import generate as jax_generate
from moolib_tpu_torch.examples.lm_serve import make_model, serve
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.rpc import Rpc, RpcError

torch.set_num_threads(1)


def test_batched_generation_served_over_rpc_matches_jax(free_port):
    flags = type("F", (), dict(
        vocab=64, d_model=32, heads=2, layers=2, seq_len=12, max_new_tokens=6,
    ))()
    jmodel = jax_lm_serve.make_model(flags)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 64, 12).astype(np.int32) for _ in range(5)]
    params = jmodel.init(jax.random.key(0), jnp.asarray(prompts[0][None]))
    model = make_model(flags, device="cpu")
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))

    def want(p):
        return np.asarray(
            jax_generate(jmodel, params, jnp.asarray(p[None]), flags.max_new_tokens))[0]

    server = Rpc()
    server.set_name("lm_server")
    server.listen(f"127.0.0.1:{free_port}")
    client = Rpc()
    client.set_name("lm_client")
    client.set_timeout(60)
    client.connect(f"127.0.0.1:{free_port}")
    try:
        coro = serve(server, model, flags.max_new_tokens, total=5)
        futs = [client.async_("lm_server", "generate", p) for p in prompts]
        iterations = asyncio.run(asyncio.wait_for(coro, 120))
        assert iterations < 5, f"no batching happened ({iterations} iterations)"
        for p, fut in zip(prompts, futs):
            got = np.asarray(fut.result(60))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want(p))

        # A bad request (prompt too long for the cache) errors THAT caller
        # and the server keeps serving.
        coro2 = serve(server, model, flags.max_new_tokens, name="generate2", total=2)
        t = threading.Thread(target=lambda: asyncio.run(coro2))
        t.start()
        bad = client.async_("lm_server", "generate2", np.zeros(64, np.int32))
        with pytest.raises(RpcError, match="generate failed"):
            bad.result(60)
        ok = client.async_("lm_server", "generate2", prompts[0])
        np.testing.assert_array_equal(np.asarray(ok.result(60)), want(prompts[0]))
        t.join(120)
        assert not t.is_alive()
    finally:
        client.close()
        server.close()


def test_poisoned_row_errors_only_its_caller(free_port):
    """Blast-radius isolation: a batch that fails is retried row by row, so
    only the offending caller sees the error."""
    flags = type("F", (), dict(
        vocab=64, d_model=32, heads=2, layers=1, seq_len=8, max_new_tokens=4,
    ))()
    model = make_model(flags, device="cpu", generator=torch.Generator().manual_seed(3))
    good = np.arange(2, 10, dtype=np.int32)
    bad = np.full(8, 999, np.int32)  # out of the vocabulary: generate() refuses it
    server = Rpc()
    server.set_name("lm_server")
    server.listen(f"127.0.0.1:{free_port}")
    client = Rpc()
    client.set_name("lm_client")
    client.set_timeout(60)
    client.connect(f"127.0.0.1:{free_port}")
    try:
        coro = serve(server, model, flags.max_new_tokens, batch_size=2, total=2)
        f_good = client.async_("lm_server", "generate", good)
        f_bad = client.async_("lm_server", "generate", bad)
        deadline = time.monotonic() + 30
        while client.sync("lm_server", "generate_stats")["depth_max"] < 2:
            assert time.monotonic() < deadline, "requests never reached the queue"
            time.sleep(0.01)
        asyncio.run(asyncio.wait_for(coro, 60))
        with pytest.raises(RpcError, match=r"generate failed: prompt tokens must lie in \[0, 64\)"):
            f_bad.result(60)
        got = np.asarray(f_good.result(60))
        assert got.shape == (12,) and np.array_equal(got[:8], good)
        stats = client.sync("lm_server", "generate_stats")
        assert stats["batch_retries"] == 1 and stats["iterations"] == 1
    finally:
        client.close()
        server.close()
