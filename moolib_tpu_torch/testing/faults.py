"""Seeded fault-injection plane (docs/RESILIENCE.md).

``tests/test_rpc_sim.py`` proved the value of *deterministic* faults at the
``send_frame`` seam — every reliability invariant is pinned by a scripted
scenario instead of a flaky churn loop.  This module generalizes that idea
into one seed-driven plane covering every fault domain the stack claims to
survive:

- **RPC frames**: :class:`FrameFaults` wraps the ``send_frame`` seam both
  transport backends share and drops / duplicates / holds (reorders) frames
  with seeded per-frame decisions — same seed, same frame sequence, same
  faults.
- **EnvPool workers**: SIGKILL / SIGSTOP / SIGCONT a worker slot of a live
  pool (exercises the :class:`~moolib_tpu_torch.envpool.RestartPolicy`
  supervisor).
- **Cohort peers**: kill a peer process (broker eviction + epoch churn).
- **Checkpoints**: truncate files inside the newest ``step_<N>/`` so
  ``Checkpointer.restore()`` must fall back to the newest *intact* one.

A :class:`FaultPlan` owns independent seeded RNG streams per fault kind and
records every action it takes (``plan.actions``) so a failing chaos run can
be replayed exactly.  ``scripts/chaos_soak.py`` and the supervision tests
are the consumers; :func:`install_from_env` lets a *subprocess* opt into
frame faults via the ``MOOLIB_FAULTS`` env knob (a strict no-op when
unset), which is how the soak injects RPC chaos into real training peers.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FaultPlan", "FrameFaults", "Partition", "install_from_env"]


class FrameFaults:
    """Seeded drop/dup/hold of outgoing RPC frames at the ``send_frame``
    seam (the single choke point both the asyncio and the native transport
    share — same seam as ``tests/test_rpc_sim.py``'s scripted ``FrameSim``).

    Probabilities are per frame; decisions come from a private
    ``random.Random`` under a lock, so for a given seed the decision
    *sequence* is deterministic (the mapping onto frames follows the send
    order, which concurrency can vary — chaos runs assert on recovery, not
    on which exact frame was hit).  A held frame is flushed right after the
    next passing frame on the same connection: a deterministic reorder.

    Use as a context manager, or ``install()``/``uninstall()`` for
    process-lifetime injection (:func:`install_from_env`).
    """

    def __init__(
        self,
        rng: random.Random,
        drop: float = 0.0,
        dup: float = 0.0,
        hold: float = 0.0,
        kinds: Optional[Sequence[int]] = None,
    ):
        if drop + dup + hold > 1.0:
            raise ValueError("drop + dup + hold must be <= 1")
        self._rng = rng
        self.drop = float(drop)
        self.dup = float(dup)
        self.hold = float(hold)
        self.kinds = None if kinds is None else frozenset(int(k) for k in kinds)
        self.counts: Dict[str, int] = {"pass": 0, "drop": 0, "dup": 0, "hold": 0}
        self._lock = threading.Lock()
        self._held: Dict[int, List[list]] = {}  # id(conn) -> held frames
        self._originals: List[Tuple[type, object]] = []

    def _decide(self) -> str:
        with self._lock:
            r = self._rng.random()
        if r < self.drop:
            return "drop"
        if r < self.drop + self.dup:
            return "dup"
        if r < self.drop + self.dup + self.hold:
            return "hold"
        return "pass"

    def _wrap(self, cls, orig):
        faults = self

        def send(conn_self, chunks):
            if not chunks:
                return orig(conn_self, chunks)
            if faults.kinds is not None:
                kind = bytes(chunks[0][:1])
                if not kind or kind[0] not in faults.kinds:
                    return orig(conn_self, chunks)
            action = faults._decide()
            with faults._lock:
                faults.counts[action] += 1
                if action == "drop":
                    return None
                if action == "hold":
                    # Materialize: callers may reuse their buffers.
                    faults._held.setdefault(id(conn_self), []).append(
                        [bytes(c) for c in chunks]
                    )
                    return None
                held = faults._held.pop(id(conn_self), [])
            rv = orig(conn_self, chunks)
            if action == "dup":
                orig(conn_self, chunks)
            for h in held:  # flush AFTER the passing frame: reorder
                orig(conn_self, h)
            return rv

        return send

    def install(self) -> "FrameFaults":
        if self._originals:
            return self  # already installed
        from ..rpc import core as rpc_core

        # Both backends override send_frame, so patch each class's own.
        for cls in (rpc_core._Connection, rpc_core._NativeConnection):
            orig = cls.__dict__["send_frame"]
            self._originals.append((cls, orig))
            cls.send_frame = self._wrap(cls, orig)
        # Disable the memfd-multicast broadcast fast path while the seam is
        # hooked: it writes frames without going through send_frame, which
        # would hide the share-down traffic from fault injection.
        rpc_core.frame_seam_hooked = True
        return self

    def uninstall(self) -> None:
        from ..rpc import core as rpc_core

        for cls, orig in self._originals:
            cls.send_frame = orig
        self._originals = []
        rpc_core.frame_seam_hooked = False

    def __enter__(self) -> "FrameFaults":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


class Partition:
    """Simulated bidirectional network partition at the ``send_frame`` seam
    of both transports: while active, any frame whose SENDER and RECEIVER
    sit on opposite sides of the cut is silently dropped — both directions,
    a real partition has no half-open mercy.  Peers named in neither side
    are unaffected (so a test can cut a cohort in half while its own
    observation channel stays up).

    Sender identity comes from the connection's owning Rpc
    (``conn.rpc``), receiver identity from the greeting
    (``conn.peer_name``); frames to a peer whose greeting hasn't completed
    pass through — a TCP connect still succeeds across a frame-layer
    partition, but every post-greeting frame (pings, pushes, keepalives)
    is then dropped, which is exactly what the liveness machinery keys on.

    ``install()`` hooks the seam; the cut itself is switched with
    ``start()``/``heal()`` (or scheduled by the ``start``/``duration``
    seconds given to :meth:`FaultPlan.partition`).  Use as a context
    manager for install/uninstall.
    """

    def __init__(self, groups: Sequence[Sequence[str]],
                 start: Optional[float] = None,
                 duration: Optional[float] = None):
        if len(groups) != 2:
            raise ValueError("partition takes exactly two peer-name groups")
        self.a = frozenset(str(n) for n in groups[0])
        self.b = frozenset(str(n) for n in groups[1])
        overlap = self.a & self.b
        if overlap:
            raise ValueError(f"peer(s) on both sides of the cut: {sorted(overlap)}")
        self.active = False
        self.dropped = 0
        self._lock = threading.Lock()
        self._originals: List[Tuple[type, object]] = []
        self._timers: List[threading.Timer] = []
        self._start_after = start
        self._duration = duration

    def _severed(self, sender: Optional[str], receiver: Optional[str]) -> bool:
        if sender is None or receiver is None:
            return False
        return ((sender in self.a and receiver in self.b)
                or (sender in self.b and receiver in self.a))

    def _wrap(self, cls, orig):
        part = self

        def send(conn_self, chunks):
            if part.active:
                rpc = getattr(conn_self, "rpc", None)
                sender = rpc.get_name() if rpc is not None else None
                if part._severed(sender, conn_self.peer_name):
                    with part._lock:
                        part.dropped += 1
                    return None
            return orig(conn_self, chunks)

        return send

    def start(self) -> None:
        self.active = True

    def heal(self) -> None:
        self.active = False

    def install(self) -> "Partition":
        if self._originals:
            return self  # already installed
        from ..rpc import core as rpc_core

        for cls in (rpc_core._Connection, rpc_core._NativeConnection):
            orig = cls.__dict__["send_frame"]
            self._originals.append((cls, orig))
            cls.send_frame = self._wrap(cls, orig)
        # Same reasoning as FrameFaults: the memfd-multicast broadcast fast
        # path bypasses send_frame and would leak frames across the cut.
        rpc_core.frame_seam_hooked = True
        if self._start_after is None and self._duration is None:
            pass  # manual start()/heal()
        else:
            delay = self._start_after or 0.0
            if delay > 0:
                t = threading.Timer(delay, self.start)
                t.daemon = True
                t.start()
                self._timers.append(t)
            else:
                self.start()
            if self._duration is not None:
                t = threading.Timer(delay + self._duration, self.heal)
                t.daemon = True
                t.start()
                self._timers.append(t)
        return self

    def uninstall(self) -> None:
        from ..rpc import core as rpc_core

        for t in self._timers:
            t.cancel()
        self._timers = []
        self.active = False
        for cls, orig in self._originals:
            cls.send_frame = orig
        self._originals = []
        rpc_core.frame_seam_hooked = False

    def __enter__(self) -> "Partition":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


class FaultPlan:
    """Deterministic, seed-driven fault schedule.

    Each fault kind draws from its own derived RNG stream (``seed:name``),
    so adding faults of one kind never perturbs another kind's sequence.
    Every injected fault is appended to ``actions`` for replay/triage.
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.actions: List[Tuple] = []
        self._streams: Dict[str, random.Random] = {}

    def rng(self, name: str) -> random.Random:
        """The named derived stream (created on first use)."""
        r = self._streams.get(name)
        if r is None:
            r = self._streams[name] = random.Random(f"{self.seed}:{name}")
        return r

    def _record(self, *event) -> None:
        self.actions.append(event)

    # ------------------------------------------------------------ rpc frames
    def frame_faults(
        self,
        drop: float = 0.0,
        dup: float = 0.0,
        hold: float = 0.0,
        kinds: Optional[Sequence[int]] = None,
    ) -> FrameFaults:
        """A :class:`FrameFaults` injector on this plan's ``rpc`` stream."""
        self._record("frame_faults", drop, dup, hold)
        return FrameFaults(self.rng("rpc"), drop=drop, dup=dup, hold=hold, kinds=kinds)

    # -------------------------------------------------------- envpool workers
    def _pick_worker(self, pool, index: Optional[int]) -> int:
        if index is None:
            index = self.rng("envpool").randrange(pool._num_processes)
        return int(index)

    def kill_envpool_worker(self, pool, index: Optional[int] = None,
                            sig: int = signal.SIGKILL) -> int:
        """SIGKILL (by default) one worker of a live pool; returns the slot
        index.  The pool's supervisor respawns it per its RestartPolicy."""
        index = self._pick_worker(pool, index)
        pid = pool._procs[index].pid
        self._record("kill_envpool_worker", index, pid, sig)
        os.kill(pid, sig)
        return index

    def freeze_envpool_worker(self, pool, index: Optional[int] = None) -> int:
        """SIGSTOP a worker: alive but not progressing — the wedge the
        step timeout / watchdog must catch (not a respawn case)."""
        index = self._pick_worker(pool, index)
        self._record("freeze_envpool_worker", index)
        os.kill(pool._procs[index].pid, signal.SIGSTOP)
        return index

    def thaw_envpool_worker(self, pool, index: int) -> None:
        self._record("thaw_envpool_worker", index)
        os.kill(pool._procs[index].pid, signal.SIGCONT)

    # ----------------------------------------------------------- cohort peers
    def poisson_kills(self, rate: float, window: float) -> List[float]:
        """Rolling peer-kill schedule: kill times (seconds from start) drawn
        from a Poisson arrival process with ``rate`` kills/second over
        ``window`` seconds — the standard preemptible/spot churn model
        (exponential inter-arrivals on this plan's ``poisson`` stream, so
        the schedule is fully determined by the seed).

        The consumer (``scripts/chaos_soak.py`` or the autoscaler soak)
        sleeps toward each time and kills whichever peer its own ``kills``
        stream picks then; the schedule itself is just the arrival clock."""
        if rate <= 0 or window <= 0:
            return []
        rng = self.rng("poisson")
        times: List[float] = []
        t = rng.expovariate(rate)
        while t < window:
            times.append(round(t, 3))
            t += rng.expovariate(rate)
        self._record("poisson_kills", rate, window, tuple(times))
        return times

    def kill_process(self, proc, sig: int = signal.SIGKILL) -> None:
        """Kill a peer process (``subprocess.Popen`` or bare pid): broker
        eviction, epoch churn, and leader re-election on the survivors."""
        pid = getattr(proc, "pid", proc)
        self._record("kill_process", pid, sig)
        os.kill(pid, sig)

    # ----------------------------------------------------------- broker plane
    def partition(self, groups: Sequence[Sequence[str]],
                  start: Optional[float] = None,
                  duration: Optional[float] = None) -> Partition:
        """A :class:`Partition` between two peer-name sets — bidirectional
        frame drop at the ``send_frame`` seam.  ``start`` seconds after
        ``install()`` the cut activates (0/None-with-duration = at once),
        healing ``duration`` seconds later; omit both for manual
        ``start()``/``heal()`` control.  The invariant this arms
        (docs/RESILIENCE.md "Network partition"): after the heal, the
        cohort re-forms on ONE fenced broker generation — the minority
        side's promoted standby or zombie primary must demote, never
        leaving two live primaries."""
        self._record("partition", tuple(sorted(groups[0])),
                     tuple(sorted(groups[1])), start, duration)
        return Partition(groups, start=start, duration=duration)

    def broker_kill_time(self, window: float) -> float:
        """When (seconds from start) to SIGKILL the primary broker, drawn
        uniformly from the middle half of ``window`` on the ``broker``
        stream — always mid-allreduce / mid-serve, never at the edges
        where the kill degenerates into a clean start/stop."""
        t = round(window * (0.25 + 0.5 * self.rng("broker").random()), 3)
        self._record("broker_kill_time", window, t)
        return t

    def broker_kill(self, proc, sig: int = signal.SIGKILL) -> None:
        """SIGKILL the primary broker process.  The failover invariant this
        arms: every peer re-targets a hot standby within the
        ``recovery_seconds{phase="broker_failover"}`` budget, and no
        request or contribution is lost to the control-plane change."""
        pid = getattr(proc, "pid", proc)
        self._record("broker_kill", pid, sig)
        os.kill(pid, sig)

    # --------------------------------------------------------- serving plane
    def replica_kill_time(self, window: float) -> float:
        """When (seconds from start) to SIGKILL a serving replica, drawn
        uniformly from the middle half of ``window`` on the ``serving``
        stream — always *mid-stream*, never at the edges where the kill
        degenerates into a clean pre-start or post-drain shutdown."""
        t = round(window * (0.25 + 0.5 * self.rng("serving").random()), 3)
        self._record("replica_kill_time", window, t)
        return t

    def replica_kill(self, procs: Sequence, index: Optional[int] = None,
                     sig: int = signal.SIGKILL) -> int:
        """SIGKILL one serving replica out of ``procs`` (picked on the
        ``serving`` stream when ``index`` is None); returns the victim's
        index.  The failover invariant this arms: every request a
        :class:`~moolib_tpu_torch.serving.ServeClient` has in flight on the victim
        must still complete on a surviving replica — latency, not loss."""
        if index is None:
            index = self.rng("serving").randrange(len(procs))
        index = int(index)
        pid = getattr(procs[index], "pid", procs[index])
        self._record("replica_kill", index, pid, sig)
        os.kill(pid, sig)
        return index

    # ------------------------------------------------------------ checkpoints
    def truncate_checkpoint(self, path: str, step: Optional[int] = None) -> Optional[str]:
        """Truncate the biggest payload file of a checkpoint to half its
        size (manifest left intact, so validation sees the corruption).

        ``path`` is a ``Checkpointer`` directory (newest ``step_<N>/`` by
        default, or ``step``) or a single pickle file.  Returns the
        truncated file path, or None when there was nothing to corrupt."""
        target_dir = path
        if os.path.isfile(path):
            return self._truncate_file(path)
        if not os.path.isdir(path):
            return None
        if step is None:
            steps = []
            for name in os.listdir(path):
                if name.startswith("step_") and not name.endswith(".tmp"):
                    try:
                        steps.append(int(name[len("step_"):]))
                    except ValueError:
                        pass
            if not steps:
                return None
            step = max(steps)
        target_dir = os.path.join(path, f"step_{step}")
        victim, size = None, -1
        for root, _dirs, files in os.walk(target_dir):
            for f in files:
                if f == "manifest.json":
                    continue
                full = os.path.join(root, f)
                s = os.path.getsize(full)
                if s > size:
                    victim, size = full, s
        if victim is None:
            return None
        return self._truncate_file(victim)

    def _truncate_file(self, path: str) -> str:
        size = os.path.getsize(path)
        keep = size // 2
        with open(path, "r+b") as f:
            f.truncate(keep)
        self._record("truncate", path, size, keep)
        return path

    def truncate_shard(self, ckpt_dir: str, step: Optional[int] = None,
                       rank: Optional[int] = None,
                       range_index: Optional[int] = None) -> Optional[str]:
        """Truncate one shard file of a COMMITTED distributed checkpoint to
        half its size (manifests left intact).  Targets the newest committed
        ``step_<N>/`` unless ``step`` is given; picks the victim shard on
        the ``checkpoint`` stream unless ``rank``/``range_index`` pin it
        (``rank == range_index`` names a primary copy, anything else a
        replica).  Returns the truncated path, or None when no committed
        shard exists.  The invariant this arms: restore must detect the
        short read via the per-shard sha256, reconstruct from a surviving
        replica or fall back to an older committed snapshot — never
        deserialize torn bytes."""
        step_dir = self._committed_step_dir(ckpt_dir, step)
        if step_dir is None:
            return None
        shards = sorted(
            f for f in os.listdir(step_dir)
            if f.startswith("shard_") and f.endswith(".bin")
        )
        if not shards:
            return None
        if rank is not None:
            shards = [f for f in shards if f.startswith(f"shard_{int(rank)}_")]
        if range_index is not None:
            shards = [
                f for f in shards if f.endswith(f"_{int(range_index)}.bin")
            ]
        if not shards:
            return None
        victim = shards[self.rng("checkpoint").randrange(len(shards))]
        return self._truncate_file(os.path.join(step_dir, victim))

    def tear_cohort_manifest(self, ckpt_dir: str,
                             step: Optional[int] = None) -> Optional[str]:
        """Un-commit a distributed checkpoint: rename its cohort manifest
        back to ``.pending``, recreating the exact on-disk state of a leader
        lost between commit phase 1 and phase 2.  Returns the torn step dir,
        or None when nothing was committed.  The invariant: a torn
        checkpoint is NEVER eligible — restore must select an older
        committed snapshot (or report none) without reading the shards."""
        step_dir = self._committed_step_dir(ckpt_dir, step)
        if step_dir is None:
            return None
        manifest = os.path.join(step_dir, "cohort_manifest.json")
        os.replace(manifest, manifest + ".pending")
        self._record("tear_cohort_manifest", step_dir)
        return step_dir

    def kill_mid_shard_write(self, proc, ckpt_dir: str,
                             timeout: float = 30.0,
                             sig: int = signal.SIGKILL) -> Optional[str]:
        """SIGKILL ``proc`` the moment a shard write is in flight under
        ``ckpt_dir`` (a ``shard_*.tmp`` staging file exists — widen the
        window with ``MOOLIB_CKPT_WRITE_DELAY`` in the victim's env).
        Returns the tmp path that triggered the kill, or None if no write
        started within ``timeout`` (no kill sent).  The invariant: the
        half-written shard has no committed cohort manifest, so restore
        ignores the whole step dir."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for root, _dirs, files in os.walk(ckpt_dir):
                for f in files:
                    if f.startswith("shard_") and f.endswith(".tmp"):
                        full = os.path.join(root, f)
                        pid = getattr(proc, "pid", proc)
                        self._record("kill_mid_shard_write", full, pid, sig)
                        os.kill(pid, sig)
                        return full
            time.sleep(0.002)
        self._record("kill_mid_shard_write", None, None, 0)
        return None

    @staticmethod
    def _committed_step_dir(ckpt_dir: str,
                            step: Optional[int] = None) -> Optional[str]:
        """Newest ``step_<N>/`` under ``ckpt_dir`` holding a committed
        cohort manifest (or the one for ``step``); None when absent."""
        if not os.path.isdir(ckpt_dir):
            return None
        steps = []
        for name in os.listdir(ckpt_dir):
            if not name.startswith("step_"):
                continue
            try:
                n = int(name[len("step_"):])
            except ValueError:
                continue
            if os.path.exists(
                os.path.join(ckpt_dir, name, "cohort_manifest.json")
            ):
                steps.append(n)
        if step is not None:
            return (os.path.join(ckpt_dir, f"step_{int(step)}")
                    if int(step) in steps else None)
        if not steps:
            return None
        return os.path.join(ckpt_dir, f"step_{max(steps)}")


_env_installed: Optional[FrameFaults] = None


def install_from_env() -> Optional[FrameFaults]:
    """Opt-in chaos for real entry points: when ``MOOLIB_FAULTS`` is set
    (e.g. ``"seed=7,rpc_drop=0.02,rpc_dup=0.01,rpc_hold=0.005"``), install
    seeded frame faults for the life of the process and return the
    injector.  Unset/empty → None, nothing touched.  Idempotent.
    """
    global _env_installed
    spec = os.environ.get("MOOLIB_FAULTS")
    if not spec:
        return None
    if _env_installed is not None:
        return _env_installed
    kv: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"MOOLIB_FAULTS: expected key=value, got {part!r}")
        k, v = part.split("=", 1)
        kv[k.strip()] = v.strip()
    plan = FaultPlan(int(kv.get("seed", "0")))
    faults = plan.frame_faults(
        drop=float(kv.get("rpc_drop", "0")),
        dup=float(kv.get("rpc_dup", "0")),
        hold=float(kv.get("rpc_hold", "0")),
    )
    _env_installed = faults.install()
    return _env_installed
