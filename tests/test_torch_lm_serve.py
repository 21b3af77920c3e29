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


def _start_server(argv, root, env):
    """``python -m moolib_tpu_torch.examples.lm_serve`` in its own process,
    returned once it has printed its readiness line."""
    import subprocess
    import sys

    proc = subprocess.Popen([sys.executable, "-m", "moolib_tpu_torch.examples.lm_serve", *argv],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            break
        lines.append(line)
        if line.startswith("serving 'generate' on"):
            return proc, lines
    proc.kill()
    raise AssertionError(f"server never came up: {''.join(lines)[-3000:]}")


def _client_replies(capsys, argv):
    """Run the client mode of main() here; its printed continuations."""
    from moolib_tpu_torch.examples.lm_serve import main

    main(argv)
    out = capsys.readouterr().out.splitlines()
    return [np.array(eval(ln.split("->")[1]), np.int32) for ln in out if "->" in ln]


def test_engine_and_replica_modes_serve_every_client_mode(capsys):
    """main() as servers, each in its own process on the CPU: an --engine
    replica and a batch-synchronous --broker replica subscribed to a
    publisher, registered with a port broker.  The --connect client (to the
    engine replica) and the --broker client (to the other) get JAX
    generate()'s continuations on the replicas' weights; after a new
    version is published, the replica answers with it."""
    import os

    from conftest import grab_port, subprocess_env
    from moolib_tpu_torch import Broker
    from moolib_tpu_torch.examples.lm_serve import make_model
    from moolib_tpu_torch.models.convert import to_flax
    from moolib_tpu_torch.serving import ModelPublisher

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(subprocess_env(root), OMP_NUM_THREADS="1")
    widths = ["--vocab", "64", "--d_model", "32", "--heads", "2", "--layers", "2",
              "--seq_len", "8", "--max_new_tokens", "6", "--seed", "3", "--prompts", "3"]
    flags = type("F", (), dict(vocab=64, d_model=32, heads=2, layers=2, seq_len=8,
                               max_new_tokens=6))()
    jmodel = jax_lm_serve.make_model(flags)
    broker_addr = f"127.0.0.1:{grab_port()}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(broker_addr)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            broker.update()
            stop.wait(0.05)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    pub_rpc = Rpc()
    pub_rpc.set_name("pusher")
    pub_rpc.listen("127.0.0.1:0")
    pub_rpc.connect(broker_addr)
    pub = ModelPublisher(pub_rpc)
    eng_addr, rep_addr = f"127.0.0.1:{grab_port()}", f"127.0.0.1:{grab_port()}"
    procs = []
    try:
        for argv in (["--listen", eng_addr, "--name", "eng0", "--engine", "--slots", "2",
                      "--block_size", "4", "--broker", broker_addr, "--group", "serve_engine"],
                     ["--listen", rep_addr, "--name", "rep0", "--broker", broker_addr,
                      "--publisher", "pusher", "--batch_size", "4"]):
            proc, lines = _start_server(argv + widths + ["--device", "cpu"], root, env)
            procs.append(proc)
            assert any(ln.startswith("precompiling") for ln in lines), lines

        def want(model_seed, replies):
            params = to_flax(make_model(flags, "cpu", torch.Generator().manual_seed(model_seed)))
            rng = np.random.default_rng(3 + 1)  # the client's prompts
            for got in replies:
                prompt = rng.integers(2, 64, 8).astype(np.int32)
                ref = np.asarray(jax_generate(jmodel, params, jnp.asarray(prompt[None]), 6))[0]
                np.testing.assert_array_equal(got, ref[8:])
            assert len(replies) == 3

        want(3, _client_replies(capsys, ["--connect", eng_addr, "--name", "eng0"] + widths))
        want(3, _client_replies(capsys, ["--broker", broker_addr] + widths))

        pub.publish(to_flax(make_model(flags, "cpu", torch.Generator().manual_seed(7))),
                    version=1)
        probe = Rpc()
        probe.set_name("probe")
        probe.connect(rep_addr)
        try:
            deadline = time.monotonic() + 30
            while probe.sync("rep0", "generate_stats")["model_version"] != 1:
                assert time.monotonic() < deadline, "the replica never swapped"
                time.sleep(0.1)
        finally:
            probe.close()
        want(7, _client_replies(capsys, ["--broker", broker_addr] + widths))
    finally:
        for proc in procs:
            proc.terminate()
            proc.wait(30)
        pub.close()
        pub_rpc.close()
        stop.set()
        pumper.join(5)
        broker.close()
