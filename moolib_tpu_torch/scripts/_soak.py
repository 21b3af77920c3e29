"""What every fleet soak shares: its log line, ports, child processes and
their environment, and the waits on them.

Child logs go under the soak's own work directory, so two soaks at once
never write one file.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Iterable, Optional

from .._device import resolve

# The repository root: spawned children import the port from here.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
T0 = time.monotonic()

# The widths of the LM processes a soak spawns (``--vocab --d_model
# --layers --heads --seq_len --batch_size --attention``).
LM_SHAPE_FLAGS = ("vocab", "d_model", "layers", "heads", "seq_len", "batch_size", "attention")


def logger(soak: str) -> Callable[[str], None]:
    """``log(msg)`` printing ``[soak +seconds] msg``, seconds since import."""

    def log(msg: str) -> None:
        print(f"[{soak} +{time.monotonic() - T0:6.1f}s] {msg}", flush=True)

    return log


def device_arg(device: Optional[str]) -> str:
    """The device every child of a soak runs on: the card unless ``device``
    names another; raises ``NoCudaError`` when the card is missing."""
    return str(resolve(device))


def add_lm_shape_flags(ap, **defaults) -> None:
    """The spawned LM processes' shape flags, with the JAX script's widths
    as ``defaults``."""
    for name in LM_SHAPE_FLAGS:
        if name == "attention":
            ap.add_argument("--attention", default=defaults.get("attention", "dense"),
                            choices=["dense", "flash"])
        else:
            ap.add_argument(f"--{name}", type=int, default=defaults[name])


def lm_shape_args(flags, names: Iterable[str] = LM_SHAPE_FLAGS) -> list:
    """``flags``' LM shape flags as an argv."""
    out = []
    for name in names:
        out += [f"--{name}", str(getattr(flags, name))]
    return out


def workdir(path: Optional[str], prefix: str) -> str:
    """``path`` (made if missing), or a new temporary directory."""
    if not path:
        import tempfile

        return tempfile.mkdtemp(prefix=prefix)
    os.makedirs(path, exist_ok=True)
    return path


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def child_env(faults: str = "", extra_env=None) -> dict:
    """A child's environment: the port importable from ``ROOT``, one CPU
    thread each (children share the host's cores), ``MOOLIB_FAULTS`` set
    to ``faults`` or removed.  The kernel build directory is the package's
    own (or ``MOOLIB_COMPILE_CACHE``), shared by every child, so a
    respawned child loads what the first one built."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("OMP_NUM_THREADS", "1")
    if faults:
        env["MOOLIB_FAULTS"] = faults
    else:
        env.pop("MOOLIB_FAULTS", None)
    if extra_env:
        env.update(extra_env)
    return env


def spawn(module: str, args: list, log_path: str, faults: str = "",
          extra_env=None) -> subprocess.Popen:
    """``python -m module args`` in its own session, stdout and stderr to
    ``log_path``."""
    with open(log_path, "w") as f:
        return subprocess.Popen([sys.executable, "-m", module, *args], stdout=f,
                                stderr=subprocess.STDOUT, env=child_env(faults, extra_env),
                                cwd=ROOT, start_new_session=True)


def kill_tree(proc) -> None:
    """SIGKILL ``proc``'s process group (a no-op once it exited) and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            proc.kill()
    proc.wait()


def read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def await_line(log_path: str, proc, marker: str, timeout: float) -> None:
    """Wait until ``marker`` appears in ``log_path``; raise if ``proc``
    dies first or ``timeout`` passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if marker in read(log_path):
            return
        if proc.poll() is not None:
            raise RuntimeError(f"child died before '{marker}': {read(log_path)[-2000:]}")
        time.sleep(0.1)
    raise RuntimeError(f"'{marker}' not seen within {timeout:.0f}s")


def wait_for(pred, deadline: float, what: str, procs=()):
    """``pred()``'s first truthy value before ``deadline`` (monotonic);
    SystemExit when a child of ``procs`` fails or the deadline expires."""
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        for p in procs:
            if p.poll() not in (None, 0):
                raise SystemExit(f"FAIL: child died (rc={p.returncode}) while {what}")
        time.sleep(0.25)
    raise SystemExit(f"FAIL: deadline expired while {what}")


def dump_tail(path: str, n: int = 2000) -> None:
    sys.stderr.write(f"--- tail of {path} ---\n{read(path)[-n:]}\n")


def json_line(text: str, prefix: str):
    """The JSON object of the last line of ``text`` that starts with
    ``prefix`` (e.g. ``"kernel_launches: "``), or None."""
    import json

    found = None
    for line in text.splitlines():
        if line.startswith(prefix):
            found = line[len(prefix):]
    return json.loads(found) if found is not None else None
