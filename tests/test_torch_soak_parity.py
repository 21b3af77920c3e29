"""The port's fleet soaks (``moolib_tpu_torch.scripts``) against the JAX
package's scripts (``scripts/``), without starting a process:

- for the same ``--seed`` and flags each port soak derives the JAX script's
  seeded schedule (broker and replica kill times, the victims, the swap
  time, the Poisson arrivals, the EnvPool victim), from the JAX package's
  own ``FaultPlan``;
- every flag the JAX script has, the port's soak has, with its default
  (the gates' thresholds are flags);
- every key the JAX script writes into its verdict, the port's writes;
- the JAX scripts' log parsers read the port's LM log lines (a resumed,
  distributed-checkpoint elastic run on the CPU) as the port's parsers do.
"""

import ast
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import autoscale_soak as jax_autoscale  # noqa: E402
import chaos_soak as jax_chaos  # noqa: E402

from moolib_tpu.testing import FaultPlan as JaxPlan  # noqa: E402
from moolib_tpu_torch.scripts import (  # noqa: E402
    autoscale_soak,
    broker_soak,
    chaos_soak,
    replay_smoke,
    serve_soak,
)
from moolib_tpu_torch.testing import FaultPlan  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 10, 123)
SOAKS = {"broker_soak": broker_soak, "serve_soak": serve_soak, "chaos_soak": chaos_soak,
         "autoscale_soak": autoscale_soak, "replay_smoke": replay_smoke}


def _jax_script(name: str) -> str:
    return os.path.join(ROOT, "scripts", f"{name}.py")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("smoke", [True, False])
def test_broker_kill_times_match(seed, smoke):
    flags = broker_soak.parse_flags(["--seed", str(seed)] + (["--smoke"] if smoke else []))
    jp = JaxPlan(seed)
    # The JAX script draws the training phase's time, then the serving one's.
    want = [jp.broker_kill_time(flags.window_s), jp.broker_kill_time(flags.window_s)]
    got = broker_soak.schedule(flags, FaultPlan(seed))
    assert [got["training_kill_t"], got["serving_kill_t"]] == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("window", [None, "20", "37.5"])
def test_replica_kill_time_victim_and_swap_match(seed, window):
    argv = ["--seed", str(seed), "--smoke"] + (["--window_s", window] if window else [])
    flags = serve_soak.parse_flags(argv)
    jp = JaxPlan(seed)
    kill_t = jp.replica_kill_time(flags.window_s)
    # FaultPlan.replica_kill(procs) with two replicas and no index draws the
    # victim from the same stream at the kill.
    victim = jp.rng("serving").randrange(2)
    got = serve_soak.schedule(flags, FaultPlan(seed))
    assert got == {"kill_t": kill_t, "victim": victim, "swap_t": round(flags.window_s * 0.8, 3)}


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_envpool_victim_and_targets_match(seed):
    flags = chaos_soak.parse_flags(["--seed", str(seed), "--smoke"])
    jp = JaxPlan(seed)
    want_worker = jp._pick_worker(types.SimpleNamespace(_num_processes=2), None)
    got = chaos_soak.schedule(flags, FaultPlan(seed))
    assert got["envpool_worker"] == want_worker
    # The JAX script's targets: steps x 3 (phase 2, early progress at a
    # third of steps), steps x 2 (phase 4), and 30 past each resume.
    assert (got["cohort_target"], got["early_progress"], got["dckpt_target"],
            got["resume_extra"]) == (180, 20, 120, 30)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("smoke", [True, False])
def test_poisson_arrivals_and_victims_match(seed, smoke):
    flags = autoscale_soak.parse_flags(["--seed", str(seed)] + (["--smoke"] if smoke else []))
    jp, plan = JaxPlan(seed), FaultPlan(seed)
    want = jp.poisson_kills(flags.kill_rate, flags.kill_window_s)[: flags.max_kills] or [
        flags.kill_window_s / 2]
    assert autoscale_soak.kill_schedule(flags, plan) == want
    live = ["auto-3", "auto-0", "auto-1"]
    for _ in range(4):
        assert autoscale_soak.pick_victim(plan, live) == jp.rng("victim").choice(sorted(live))


def _flag_defaults(tree) -> dict:
    """``--flag`` -> the literal default of every ``add_argument`` call."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[node.args[0].value] = ast.literal_eval(kw["default"])
            else:  # argparse's own: False for a store_true switch, else None
                action = kw.get("action")
                switch = isinstance(action, ast.Constant) and action.value == "store_true"
                out[node.args[0].value] = False if switch else None
    return out


@pytest.mark.parametrize("name", sorted(SOAKS))
def test_every_jax_flag_and_default_is_kept(name):
    want = _flag_defaults(ast.parse(open(_jax_script(name)).read()))
    parser = (SOAKS[name].make_parser() if hasattr(SOAKS[name], "make_parser") else None)
    if parser is None:  # replay_smoke builds its parser in main()
        got = _flag_defaults(ast.parse(open(SOAKS[name].__file__).read()))
    else:
        got = {a.option_strings[0]: a.default for a in parser._actions if a.option_strings}
    for flag, default in want.items():
        assert flag in got, f"{name}: the port has no {flag}"
        assert got[flag] == default, f"{name} {flag}: {got[flag]!r} != {default!r}"


def _verdict_keys(path: str) -> set:
    """String keys the script writes into dicts: dict literals, subscript
    stores and ``.update(key=...)`` calls."""
    keys = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"):
            keys |= {kw.arg for kw in node.keywords if kw.arg}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str)):
            keys.add(node.slice.value)
    return keys


@pytest.mark.parametrize("name", ["broker_soak", "serve_soak", "autoscale_soak"])
def test_verdict_keys_are_the_jax_scripts(name):
    want = _verdict_keys(_jax_script(name)) - {"JAX_PLATFORMS", "PYTHONPATH"}
    got = _verdict_keys(SOAKS[name].__file__)
    assert not want - got, f"{name}: verdict keys missing in the port: {sorted(want - got)}"


@pytest.fixture(scope="module")
def lm_logs(tmp_path_factory):
    """A port elastic LM peer's log lines: a ``--shard_grads`` run writing
    distributed checkpoints, then a resumed run from its newest commit."""
    import contextlib
    import io
    import socket

    from moolib_tpu_torch.examples import lm

    tmp = tmp_path_factory.mktemp("lm_logs")

    def run(steps: int, log_name: str) -> str:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lm.train(lm.make_flags([
                "--address", f"127.0.0.1:{port}", "--local_name", "lm0", "--shard_grads",
                "--checkpoint_dir", str(tmp / "dckpt"), "--checkpoint_interval", "0.05",
                "--steps", str(steps), "--seq_len", "16", "--batch_size", "2",
                "--d_model", "16", "--layers", "1", "--heads", "1", "--vocab", "16",
                "--log_interval", "5", "--attention", "dense", "--device", "cpu"]))
        path = tmp / "fleet" / log_name / "worker.log"
        path.parent.mkdir(parents=True)
        path.write_text(buf.getvalue())
        return str(path)

    return tmp, run(20, "w0"), run(35, "w1")


def test_jax_parsers_read_the_port_lm_lines(lm_logs):
    tmp, first, resumed = lm_logs
    for path in (first, resumed):
        steps = jax_chaos.logged_steps(path)
        assert steps and steps == chaos_soak.logged_steps(path)
        assert jax_chaos.recovered_line(path) == chaos_soak.recovered_line(path) is not None
        stats = jax_chaos._ckpt_async_stats(path)
        assert stats is not None and stats == chaos_soak._ckpt_async_stats(path)
        assert stats["captures"] >= 1
    assert jax_chaos.resumed_step(first) is None
    got = jax_chaos.resumed_step(resumed)
    assert got is not None and got == chaos_soak.resumed_step(resumed)
    assert jax_chaos.logged_steps(resumed)[0] >= got  # step-counter continuity
    fleet = str(tmp / "fleet")
    for needle in ("recovered:", "vbatch_violation", "step="):
        assert (jax_autoscale.count_in_logs(fleet, needle)
                == autoscale_soak.count_in_logs(fleet, needle))
    assert jax_autoscale.count_in_logs(fleet, "recovered:") == 2
    assert jax_autoscale.worker_log_has(os.path.dirname(first), "recovered:")


@pytest.mark.parametrize("name", sorted(SOAKS))
def test_no_card_raises_without_device(name, monkeypatch, tmp_path):
    """With no ``--device`` every soak runs its children on the card; a
    missing card raises before anything starts (never a CPU fallback)."""
    from moolib_tpu_torch._device import NoCudaError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke"] + ([] if name == "replay_smoke" else ["--workdir", str(tmp_path)])
    with pytest.raises(NoCudaError):
        SOAKS[name].main(argv)
    assert not os.listdir(tmp_path)
