"""Checkpoint/resume: durable training state with atomic installs.

The port of the JAX package's ``checkpoint.py``, on the same on-disk
layouts, so either package verifies the other's artifacts:

- :class:`Checkpointer` — ``<dir>/step_<N>/`` per checkpoint, each with a
  ``manifest.json`` (step, format, file list with sizes and sha256) written
  before the atomic rename of ``step_<N>.tmp``.  The port writes
  ``state.pt`` with ``torch.save`` (``"format": "torch"``; leaves are CPU
  tensors, so ``torch.load``'s default ``weights_only=True`` reads it) and
  also restores the JAX package's ``"format": "pickle"`` checkpoints whose
  leaves are numpy / ml_dtypes arrays in plain containers — through a
  restricted unpickler, never a full one.  ``restore()`` falls back to the
  newest intact checkpoint on corruption (``checkpoint_corrupt_skipped``).
- :class:`DistributedCheckpointer` — every cohort member writes its
  byte-range shard(s) of the deterministic state blob plus a per-host
  manifest; the leader two-phase-commits ``cohort_manifest.json``.  The
  blob is ``pickle.dumps(canonical_tree(host_tree))`` with the host tree
  built as the Accumulator's model-sync blob is (:func:`host_leaf`: numpy
  leaves, bf16 as ml_dtypes where that imports), so a cohort of JAX peers,
  port peers or both writes the same bytes, and an N-host checkpoint of
  either package re-cuts onto M hosts (``buckets.shard_ranges``).

Torch tensors change in place (the optimizer step, the Accumulator's
apply), where the JAX package's arrays could not: a reference captured now
would pickle later values.  :meth:`DistributedCheckpointer.begin_capture`
therefore finishes a snapshot on the caller's thread — CUDA leaves copied
non-blocking with one event into one of two pinned staging slots, kept
and reused from capture to capture; CPU leaves cloned — and the writer
thread waits on the event.  That handoff is ``checkpoint_stall_seconds``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pickle
import queue as queue_mod
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import buckets, telemetry, utils
from .utils import nest

_REG = telemetry.get_registry()
_M_CORRUPT_SKIPPED = _REG.counter(
    "checkpoint_corrupt_skipped",
    "corrupt/partial checkpoints skipped by restore() fallback",
)
_M_STALL = _REG.histogram(
    "checkpoint_stall_seconds",
    "train-thread blocked seconds per async capture handoff (D2H issue + staging)",
)
_M_WRITE = _REG.histogram(
    "checkpoint_write_seconds",
    "background seconds per shard capture (device fetch + pickle + file write)",
)
_M_SHARD_BYTES = _REG.counter(
    "checkpoint_shard_bytes_total", "checkpoint shard payload bytes written"
)
_M_COMMITS = _REG.counter(
    "checkpoint_commits_total",
    "cohort manifests committed (two-phase commit completed)",
)
_M_DECLINED = _REG.counter(
    "checkpoint_captures_declined_total",
    "async captures declined because both staging slots were busy",
)
_M_RECONSTRUCTED = _REG.counter(
    "checkpoint_shard_reconstructions_total",
    "shard byte ranges rebuilt from a replica copy during restore",
)

_MANIFEST = "manifest.json"
_COHORT_MANIFEST = "cohort_manifest.json"
_PENDING = _COHORT_MANIFEST + ".pending"
_TORCH_FILE = "state.pt"
_PICKLE_FILE = "state.pkl"
# Chaos knob (fault-injection harnesses): seconds to hold each shard's tmp
# file before its atomic rename, widening the mid-shard-write window.
_WRITE_DELAY_ENV = "MOOLIB_CKPT_WRITE_DELAY"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def canonical_tree(tree: Any) -> Any:
    """Rebuild ``tree`` with plain-dict keys in sorted order, recursively.

    Replicated state must pickle to identical bytes on every host, but dict
    *insertion* order is a host-local artifact: a tree rebuilt from a sorted
    flatten/unflatten round-trip iterates keys sorted, while one that arrived
    through a pickle-based model sync keeps its original order.  Same values,
    different bytes, different digest.  Sorting matches the sorted-key
    flatten convention (``utils.nest.tree_flatten``), so restored trees are
    semantically unchanged.
    """
    if type(tree) is dict:
        return {k: canonical_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        vals = [canonical_tree(v) for v in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*vals)
        return tuple(vals)
    if type(tree) is list:
        return [canonical_tree(v) for v in tree]
    return tree


# ------------------------------------------------------------ host snapshots
def host_leaf(leaf):
    """One host-resident leaf as the blob pickles it, the bytes a JAX peer
    pickles for the same values: a tensor becomes a numpy array (bf16 an
    ml_dtypes array where ``ml_dtypes`` imports, else it stays a CPU
    tensor); anything else passes through."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return leaf
        return np.array(leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return np.array(leaf.numpy())


def snapshot(tree, staging: Optional[dict] = None):
    """A copy of ``tree`` that later in-place writes cannot reach, started
    on the caller's thread: ``(treedef, staged, event)``.  CUDA leaves are
    copied non-blocking into pinned host memory with ONE event
    (``buckets.stage``, into the reusable buffers of ``staging`` when
    given; the copies are ordered before any later kernel on the stream,
    so they read today's values); CPU tensors are cloned and numpy arrays
    copied.  Wait on ``event`` (None when nothing was on the card) before
    reading — :func:`host_tree` does."""
    leaves, treedef = nest.tree_flatten(tree)
    staged, event = buckets.stage(
        [l.detach() if isinstance(l, torch.Tensor) else l for l in leaves], staging)
    out = []
    for orig, leaf in zip(leaves, staged):
        if isinstance(orig, torch.Tensor):
            out.append(leaf if buckets.on_card(orig) else orig.detach().clone())
        elif isinstance(orig, np.ndarray):
            out.append(orig.copy())
        else:
            out.append(orig)
    return treedef, out, event


def host_tree(snap):
    """The blob's host tree of a :func:`snapshot` (waits on its event)."""
    treedef, staged, event = snap
    if event is not None:
        event.synchronize()
    return treedef.unflatten([host_leaf(l) for l in staged])


def _map_leaves(tree, fn):
    """``fn`` over the leaves of ``tree``, containers (and dict insertion
    order) kept — unlike ``nest.tree_map``, which sorts dict keys."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(v, fn)) for k, v in tree.items())
    if isinstance(tree, tuple):
        vals = [_map_leaves(v, fn) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def to_cpu(tree):
    """``tree`` with every tensor leaf detached onto the CPU: what
    ``torch.save`` writes, so ``torch.load`` reads it on any machine."""
    return _map_leaves(tree, lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def leaf_to_device(x, device: torch.device):
    """A numpy array (bf16 as ml_dtypes) or tensor leaf as a tensor on
    ``device``; other leaves pass through."""
    if isinstance(x, np.ndarray) and x.dtype != object:
        if x.dtype.name == "bfloat16":  # ml_dtypes
            x = torch.from_numpy(np.ascontiguousarray(x).view(np.int16).copy()).view(torch.bfloat16)
        else:
            x = torch.from_numpy(x if x.flags.writeable else x.copy())
    if isinstance(x, torch.Tensor) and x.device != device:
        x = x.to(device)
    return x


def to_device(tree, device):
    """``tree`` with numpy and tensor leaves as tensors on ``device``."""
    device = torch.device(device)
    return _map_leaves(tree, lambda x: leaf_to_device(x, device))


# ------------------------------------------------------- restricted unpickler
class UnsupportedCheckpointError(RuntimeError):
    """A checkpoint holds objects the port will not unpickle (optax state,
    flax structs, arbitrary classes).  Not corruption: ``restore`` raises
    it instead of falling back past it."""


_NUMPY_NAMES = {"_reconstruct", "_frombuffer", "scalar", "ndarray", "dtype"}
_NUMPY_MODULES = {
    "numpy", "numpy.core.multiarray", "numpy._core.multiarray",
    "numpy.core.numeric", "numpy._core.numeric",
}


def _load_storage(b: bytes):
    # A pickled torch tensor carries its storage as a nested torch.save
    # stream; read that one with weights_only too.
    return torch.load(io.BytesIO(b), weights_only=True)


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles plain containers of numpy / ml_dtypes arrays and CPU
    tensors; every other global is refused, optax by name."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if root == "ml_dtypes":
            return super().find_class(module, name)
        if (module, name) == ("collections", "OrderedDict"):
            return super().find_class(module, name)
        if (module, name) == ("torch._utils", "_rebuild_tensor_v2"):
            return super().find_class(module, name)
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _load_storage
        if root == "optax":
            raise UnsupportedCheckpointError(
                f"checkpoint holds optax state ({module}.{name}); unpickling it "
                "needs optax, which the port does not use. Save the JAX "
                "state with plain containers (e.g. only the flax params) "
                "and restore those")
        if root in ("flax", "jax", "jaxlib"):
            raise UnsupportedCheckpointError(
                f"checkpoint holds a {root} object ({module}.{name}); the port "
                "restores plain containers of numpy arrays only")
        raise pickle.UnpicklingError(
            f"checkpoint global {module}.{name} is not allowed (numpy, ml_dtypes "
            "and CPU tensors only)")


def safe_loads(blob: bytes):
    """``pickle.loads`` restricted to plain containers of numpy / ml_dtypes
    arrays and CPU tensors (the leaf forms either package's blob holds)."""
    return _ArrayUnpickler(io.BytesIO(blob)).load()


def _skip_corrupt(path: str, reason: str) -> None:
    """Log, count and record one candidate ``restore()`` falls back past."""
    _M_CORRUPT_SKIPPED.inc()
    utils.log_error("checkpoint: skipping corrupt %s (%s); falling back", path, reason)
    telemetry.flight_event("checkpoint.corrupt_skipped", path=path, reason=reason)


class Checkpointer:
    """Save/restore trees of tensors + metadata under a directory.

    Layout: ``<dir>/step_<N>/`` per checkpoint (each with a
    ``manifest.json`` integrity record) plus a ``latest`` symlink.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._warned_partial: set = set()  # manifest-less dirs already logged

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any) -> str:
        """Write a checkpoint for ``step``; returns its path.  Tensor leaves
        are copied to the CPU and written before this returns.  Atomic:
        partial writes land in a tmp dir (manifest included) that is renamed
        into place — a crash mid-save can only ever leave a ``.tmp`` husk."""
        path = self._step_path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        host_state = to_cpu(state)
        os.makedirs(tmp, exist_ok=True)
        torch.save(host_state, os.path.join(tmp, _TORCH_FILE))
        self._write_manifest(tmp, step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._update_latest(path)
        self._gc()
        utils.log_info("checkpoint: saved step %d to %s", step, path)
        return path

    def _write_manifest(self, tmp: str, step: int) -> None:
        files: Dict[str, Dict[str, object]] = {}
        for root, _dirs, names in os.walk(tmp):
            for name in names:
                if name == _MANIFEST:
                    continue
                full = os.path.join(root, name)
                rel = os.path.relpath(full, tmp)
                files[rel] = {"size": os.path.getsize(full), "sha256": _sha256(full)}
        manifest = {
            "step": int(step),
            "format": "torch",
            "time": time.time(),
            "files": files,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, target: Any = None,
                map_location=None) -> Optional[Any]:
        """Load the newest *intact* checkpoint (≤ ``step`` when given);
        None if none exists.

        A candidate whose manifest is missing, unparsable, or whose files
        fail the size/sha256 check — or whose payload fails to deserialize
        — is logged, counted (``checkpoint_corrupt_skipped``) and skipped
        in favor of the next older one.  A checkpoint the port refuses to
        unpickle (:class:`UnsupportedCheckpointError`) raises.

        Tensors land on ``map_location``; without it, on the device of
        ``target``'s first tensor leaf when a ``target`` tree is given,
        else where they were saved (the CPU).  A JAX ``"pickle"``
        checkpoint keeps its numpy leaves unless a device is named.
        """
        if map_location is None and target is not None:
            for leaf in nest.tree_leaves(target):
                if isinstance(leaf, torch.Tensor):
                    map_location = leaf.device
                    break
        candidates = self.all_steps()
        if step is not None:
            candidates = [s for s in candidates if s <= step]
            if not candidates or candidates[-1] != step:
                utils.log_error(
                    "checkpoint: step %s missing or partial under %s",
                    step, self.directory,
                )
        for cand in reversed(candidates):
            path = self._step_path(cand)
            reason = self._verify(path)
            if reason is not None:
                _skip_corrupt(path, reason)
                continue
            try:
                return self._load(path, map_location)
            except UnsupportedCheckpointError:
                raise
            except Exception as e:  # noqa: BLE001 — treat as corruption
                _skip_corrupt(path, repr(e))
        return None

    def _load(self, path: str, map_location):
        pt = os.path.join(path, _TORCH_FILE)
        if os.path.exists(pt):
            return torch.load(pt, map_location=map_location)
        pkl = os.path.join(path, _PICKLE_FILE)
        if not os.path.exists(pkl):
            raise UnsupportedCheckpointError(
                f"checkpoint {path} holds neither {_TORCH_FILE} nor {_PICKLE_FILE} "
                "(an orbax checkpoint of the JAX package?); the port restores "
                "its own and the JAX package's pickle format")
        with open(pkl, "rb") as f:
            tree = safe_loads(f.read())
        return tree if map_location is None else to_device(tree, map_location)

    def _verify(self, path: str) -> Optional[str]:
        """None when ``path`` matches its manifest; else a human reason."""
        mpath = os.path.join(path, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return f"manifest unreadable: {e}"
        files = manifest.get("files")
        if not isinstance(files, dict):
            return "manifest has no file table"
        for rel, meta in files.items():
            full = os.path.join(path, rel)
            if not os.path.exists(full):
                return f"missing file {full}"
            size = os.path.getsize(full)
            if size != meta.get("size"):
                return f"truncated {full} ({size} != {meta.get('size')} bytes)"
            actual = _sha256(full)
            if actual != meta.get("sha256"):
                return (
                    f"checksum mismatch on {full}: "
                    f"expected {meta.get('sha256')}, got {actual}"
                )
        return None

    def verify(self, step: int) -> bool:
        """Public integrity probe: does ``step`` exist and match its
        manifest byte-for-byte?"""
        return self._verify(self._step_path(step)) is None

    def all_steps(self) -> List[int]:
        """Steps with a manifest present.  A ``step_<N>/`` without one is a
        partial artifact and is ignored — it must never be selected as
        'latest'.  Skips are logged once per directory."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if not os.path.exists(os.path.join(self.directory, name, _MANIFEST)):
                    if name not in self._warned_partial:
                        self._warned_partial.add(name)
                        utils.log_error(
                            "checkpoint: ignoring %s/%s (no %s — partial or "
                            "pre-manifest; re-save to adopt it)",
                            self.directory, name, _MANIFEST,
                        )
                    continue
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> Optional[int]:
        """The newest step whose manifest verifies byte-for-byte — the step
        ``restore()`` would load — without deserializing the payload."""
        for step in reversed(self.all_steps()):
            if self._verify(self._step_path(step)) is None:
                return step
        return None

    # ------------------------------------------------------------- internals
    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _update_latest(self, path: str) -> None:
        link = os.path.join(self.directory, "latest")
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(os.path.basename(path), link)
        except OSError:
            pass

    def _gc(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            try:
                shutil.rmtree(self._step_path(victim))
            except OSError:
                pass


# --------------------------------------------------------------------------
# Distributed (cohort) checkpoints
# --------------------------------------------------------------------------
class MissingShardError(RuntimeError):
    """A committed cohort checkpoint cannot be assembled: some byte ranges
    are missing or corrupt in EVERY surviving copy.  Carries the offending
    ``(range, start, stop)`` triples."""

    def __init__(self, step: int, missing: Sequence[Tuple[int, int, int]]):
        self.step = int(step)
        self.missing = [(int(r), int(a), int(b)) for r, a, b in missing]
        detail = ", ".join(
            f"rank {r} bytes [{a}:{b})" for r, a, b in self.missing
        )
        super().__init__(f"checkpoint step {step}: missing shards ({detail})")


def shard_plan(total_bytes: int, world: int, spec: str = "replicated"):
    """Byte-range shard layout for a ``world``-host cohort.

    Rank *i* owns range *i* of ``buckets.shard_ranges(total_bytes, world)``
    and — under ``spec="replicated"`` — also writes a replica of range
    ``(i+1) % world``.  Returns ``(ranges, owned)`` where ``owned[rank]``
    lists the range indices that rank writes (own range first)."""
    ranges = buckets.shard_ranges(int(total_bytes), int(world), 1)
    owned = []
    for rank in range(int(world)):
        mine = [rank]
        if spec == "replicated" and int(world) > 1:
            mine.append((rank + 1) % int(world))
        owned.append(mine)
    return ranges, owned


def _write_json_atomic(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class DistributedCheckpointer:
    """Pod-consistent sharded checkpoints with two-phase commit.

    Each cohort member holds the full replicated training state, so a
    snapshot shards the deterministic pickle blob BY BYTE RANGE: host *i*
    writes its ~1/N slice (plus one replica slice under
    ``spec="replicated"``).  On-disk layout per ``<dir>/step_<N>/``:

    - ``shard_<rank>_<range>.bin`` — byte range ``<range>`` of the blob
      (tmp + fsync + atomic rename);
    - ``manifest_<rank>.json`` — per-host manifest: rank, world, spec, blob
      sha256, and size/sha256 of each range file that rank wrote;
    - ``cohort_manifest.json`` — the leader's commit record, written as
      ``.pending`` first (phase 1) and atomically renamed (phase 2): a
      checkpoint is eligible for restore IFF this file exists.

    Restore is elastic: any M-host cohort assembles an N-host checkpoint
    bit-exact; :meth:`restore_slice` re-cuts this host's slice for the new
    size (``Accumulator.preload_sync_slice``).  A missing range is rebuilt
    from a replica (``checkpoint_shard_reconstructions_total``) when one
    survives, else :class:`MissingShardError` names it.
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        spec: str = "replicated",
        watchdog=None,
        write_timeout: float = 120.0,
    ):
        if spec not in ("replicated", "sharded"):
            raise ValueError(f"unknown shard spec {spec!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.spec = spec
        self._wd = watchdog
        self._write_timeout = write_timeout
        # Double-buffered staging: at most two captures (one writing + one
        # queued) ride the background worker; a third is declined.  Each
        # capture holds one of two staging slots (dtype -> flat pinned
        # buffer, allocated by the first capture through it and reused), so
        # a steady run stages without allocating page-locked memory.
        self._slot_lock = threading.Lock()
        self._busy = 0
        self._staging: List[dict] = [{}, {}]
        self._free_slots = [1, 0]
        self._queue: Optional[queue_mod.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._cap_stats = {
            "captures": 0, "stall_s": 0.0, "writes": 0, "write_s": 0.0, "commits": 0,
        }
        # (step, sha16, blob) of the newest successful restore; the
        # accumulator auto-registers it as a warm-rejoin sync slice.
        self.last_restored: Optional[Tuple[int, str, bytes]] = None

    def set_watchdog(self, watchdog) -> None:
        """Attach (or replace) the watchdog whose ``section()`` arms around
        shard file writes."""
        self._wd = watchdog

    def stats(self) -> Dict[str, float]:
        """Capture-side accounting: ``captures``, ``stall_s`` (train-thread
        blocked seconds), ``writes`` (captures the worker finished) and their
        ``write_s`` (background seconds), ``commits``."""
        with self._slot_lock:
            return dict(self._cap_stats)

    def _section(self, name: str):
        if self._wd is not None:
            return self._wd.section(name, self._write_timeout)
        return contextlib.nullcontext()

    # ------------------------------------------------------------ write side
    def write_shard(self, step: int, blob: bytes, rank: int, world: int,
                    epoch=0) -> Dict[str, Any]:
        """Write this host's shard file(s) + per-host manifest for ``step``
        and return the report dict the leader's commit consumes."""
        step, rank, world = int(step), int(rank), int(world)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside cohort of {world}")
        sdir = self._step_path(step)
        os.makedirs(sdir, exist_ok=True)
        ranges, owned = shard_plan(len(blob), world, self.spec)
        delay = float(os.environ.get(_WRITE_DELAY_ENV, "0") or 0.0)
        view = memoryview(blob)
        files: Dict[str, Dict[str, Any]] = {}
        for j in owned[rank]:
            a, b = ranges[j]
            fname = f"shard_{rank}_{j}.bin"
            full = os.path.join(sdir, fname)
            tmp = full + ".tmp"
            with self._section("checkpoint_shard_write"):
                with open(tmp, "wb") as f:
                    f.write(view[a:b])
                    f.flush()
                    os.fsync(f.fileno())
                if delay:
                    time.sleep(delay)  # chaos knob: hold the torn window open
                os.replace(tmp, full)
            files[fname] = {
                "range": j, "start": a, "stop": b, "size": b - a,
                "sha256": hashlib.sha256(view[a:b]).hexdigest(),
            }
            _M_SHARD_BYTES.inc(b - a)
        report = {
            "step": step, "rank": rank, "world": world, "epoch": epoch,
            "spec": self.spec, "total_bytes": len(blob),
            "blob_sha256": hashlib.sha256(blob).hexdigest(), "files": files,
        }
        with self._section("checkpoint_shard_write"):
            _write_json_atomic(os.path.join(sdir, f"manifest_{rank}.json"), report)
        return report

    def begin_capture(self, *, step: int, rank: int, world: int, state,
                      epoch=0, on_done=None) -> bool:
        """Async capture of ``state`` (any tree) into this host's shard
        files.

        Before this returns, the caller's thread has snapshotted every leaf
        (:func:`snapshot`: CUDA leaves queued into pinned memory behind one
        event, CPU leaves cloned), so writes to the live tensors after the
        return — the next optimizer step — cannot reach the capture.  That
        handoff is ``checkpoint_stall_seconds``.  A background worker waits
        on the event, pickles, shards and writes
        (``checkpoint_write_seconds``), then calls ``on_done(report)`` — or
        ``on_done({"error": ...})`` when the capture failed — from its own
        thread.  Returns False (``checkpoint_captures_declined_total``)
        when both staging slots are busy."""
        t0 = time.monotonic()
        with self._slot_lock:
            if self._busy >= 2:
                _M_DECLINED.inc()
                return False
            self._busy += 1
            slot = self._free_slots.pop()
            self._ensure_worker_locked()
            q = self._queue
        try:
            snap = snapshot(state, self._staging[slot])
        except BaseException:
            with self._slot_lock:
                self._busy -= 1
                self._free_slots.append(slot)
            raise
        q.put((int(step), int(rank), int(world), epoch, slot, snap, on_done))
        dt = time.monotonic() - t0
        _M_STALL.observe(dt)
        with self._slot_lock:
            self._cap_stats["captures"] += 1
            self._cap_stats["stall_s"] += dt
        return True

    def _ensure_worker_locked(self) -> None:
        if self._worker is None:
            self._queue = queue_mod.Queue()
            self._worker = threading.Thread(
                target=self._worker_main, args=(self._queue,),
                name="ckpt-shard-writer", daemon=True,
            )
            self._worker.start()

    def _worker_main(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            step, rank, world, epoch, slot, snap, on_done = item
            t0 = time.monotonic()
            report = None
            try:
                host = canonical_tree(host_tree(snap))
                blob = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
                del host
                report = self.write_shard(step, blob, rank, world, epoch=epoch)
            except Exception as e:  # noqa: BLE001 — reported as a failed shard
                utils.log_error(
                    "checkpoint: shard capture for step %s failed: %r", step, e
                )
                report = {"error": f"shard capture failed: {e!r}"}
            finally:
                dt = time.monotonic() - t0
                _M_WRITE.observe(dt)
                snap = None  # the slot's buffers are free for the next capture
                with self._slot_lock:
                    self._busy -= 1
                    self._free_slots.append(slot)
                    self._cap_stats["writes"] += 1
                    self._cap_stats["write_s"] += dt
            if on_done is not None:
                try:
                    on_done(report)
                except Exception as e:  # noqa: BLE001 — hook bugs stay local
                    utils.log_error("checkpoint: on_done hook failed: %r", e)

    def close(self) -> None:
        """Stop the background writer once the queued captures are
        written."""
        with self._slot_lock:
            q, self._worker = self._queue, None
            self._queue = None
        if q is not None:
            q.put(None)

    # ----------------------------------------------------- two-phase commit
    def prepare_commit(self, step: int, reports: Sequence[Dict[str, Any]]) -> str:
        """Phase 1 (leader): validate the quorum and stage the cohort
        manifest as ``cohort_manifest.json.pending`` (fsynced).  Every rank
        ``0..world-1`` must have reported and every report must agree on
        the blob digest/size/epoch — the version-consistency proof."""
        step = int(step)
        reports = [r for r in reports if r]
        if not reports:
            raise ValueError(f"checkpoint step {step}: no shard reports")
        world = int(reports[0]["world"])
        sha = reports[0]["blob_sha256"]
        total = int(reports[0]["total_bytes"])
        epoch = reports[0].get("epoch")
        spec = reports[0].get("spec", self.spec)
        ranks = sorted(int(r["rank"]) for r in reports)
        if ranks != list(range(world)):
            raise ValueError(
                f"checkpoint step {step}: quorum incomplete "
                f"(have ranks {ranks}, want 0..{world - 1})"
            )
        for r in reports:
            key = (r["blob_sha256"], int(r["total_bytes"]), int(r["world"]),
                   r.get("epoch"))
            if key != (sha, total, world, epoch):
                raise ValueError(
                    f"checkpoint step {step}: rank {r['rank']} digest/shape "
                    f"disagrees — snapshot not version-consistent (rank 0: "
                    f"sha {sha[:16]} {total} B epoch {epoch}; "
                    f"rank {r['rank']}: sha {r['blob_sha256'][:16]} "
                    f"{int(r['total_bytes'])} B epoch {r.get('epoch')})"
                )
        cohort = {
            "step": step, "epoch": epoch, "world": world, "spec": spec,
            "total_bytes": total, "blob_sha256": sha, "time": time.time(),
            "shards": {
                str(int(r["rank"])): {"files": r["files"]} for r in reports
            },
        }
        sdir = self._step_path(step)
        os.makedirs(sdir, exist_ok=True)
        pending = os.path.join(sdir, _PENDING)
        _write_json_atomic(pending, cohort)
        return pending

    def commit(self, step: int) -> str:
        """Phase 2 (leader): atomically promote the pending cohort manifest
        — the single instant the checkpoint becomes eligible for restore."""
        sdir = self._step_path(int(step))
        pending = os.path.join(sdir, _PENDING)
        final = os.path.join(sdir, _COHORT_MANIFEST)
        if not os.path.exists(pending):
            raise FileNotFoundError(
                f"checkpoint step {step}: no pending cohort manifest to commit"
            )
        os.replace(pending, final)
        _fsync_dir(sdir)
        _M_COMMITS.inc()
        with self._slot_lock:
            self._cap_stats["commits"] += 1
        telemetry.flight_event("checkpoint.cohort_committed", step=int(step), path=final)
        utils.log_info("checkpoint: committed cohort manifest %s", final)
        self._gc()
        return final

    def commit_cohort(self, step: int, reports: Sequence[Dict[str, Any]]) -> str:
        """Both phases back to back (the leader's normal path)."""
        self.prepare_commit(step, reports)
        return self.commit(step)

    # -------------------------------------------------------------- restore
    def committed_steps(self) -> List[int]:
        """Steps whose cohort manifest is COMMITTED (phase 2 done)."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, _COHORT_MANIFEST)):
                    try:
                        steps.append(int(name[len("step_"):]))
                    except ValueError:
                        pass
        return sorted(steps)

    def latest_committed_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Tuple[int, Any]]:
        """Load the newest committed, assemblable checkpoint (≤ ``step``
        when given) as ``(step, state)``; None when nothing is committed.

        The state is the blob's tree as it was pickled — numpy (and
        ml_dtypes) leaves, or CPU tensors where the writer had no
        ml_dtypes — unless ``map_location`` names a device for tensors.
        A committed candidate whose files are truncated/corrupt falls back
        to the next older one (``checkpoint_corrupt_skipped``) after replica
        reconstruction was tried; when one failed ONLY for missing shards
        and nothing older restored, its :class:`MissingShardError` is
        raised."""
        candidates = self.committed_steps()
        if step is not None:
            candidates = [s for s in candidates if s <= step]
        missing_err = None
        for cand in reversed(candidates):
            path = self._step_path(cand)
            try:
                blob, cohort = self._assemble(cand)
                state = safe_loads(blob)
            except UnsupportedCheckpointError:
                raise
            except MissingShardError as e:
                missing_err = missing_err or e
                _skip_corrupt(path, str(e))
                continue
            except Exception as e:  # noqa: BLE001 — treat as corruption
                _skip_corrupt(path, repr(e))
                continue
            self.last_restored = (cand, cohort["blob_sha256"][:16], blob)
            if map_location is not None:
                state = to_device(state, map_location)
            return cand, state
        if missing_err is not None:
            raise missing_err
        return None

    def restore_slice(
        self, rank: int, world: int, step: Optional[int] = None
    ) -> Optional[Tuple[int, str, int, bytes, int]]:
        """Elastic re-cut: ``(step, sha16, start, data, total_bytes)`` —
        THIS host's byte slice of the newest committed blob under a
        ``world``-host layout, whatever cohort size wrote it."""
        candidates = self.committed_steps()
        if step is not None:
            candidates = [s for s in candidates if s <= step]
        if not candidates:
            return None
        cand = candidates[-1]
        blob, cohort = self._assemble(cand)
        a, b = buckets.shard_ranges(len(blob), int(world), 1)[int(rank)]
        return cand, cohort["blob_sha256"][:16], a, blob[a:b], len(blob)

    def verify(self, step: int) -> bool:
        """Public probe: is ``step`` committed AND assemblable bit-exact?"""
        try:
            self._assemble(int(step))
        except Exception:  # noqa: BLE001 — any failure means not restorable
            return False
        return True

    def _assemble(self, step: int) -> Tuple[bytes, Dict[str, Any]]:
        sdir = self._step_path(int(step))
        with open(os.path.join(sdir, _COHORT_MANIFEST)) as f:
            cohort = json.load(f)
        total = int(cohort["total_bytes"])
        world = int(cohort["world"])
        buf = bytearray(total)
        # Candidate files per range, primary (owner rank == range) first so
        # replica reads are countable reconstructions.
        by_range: Dict[int, List[Tuple[bool, str, Dict[str, Any]]]] = {}
        for rank_s, shard in cohort.get("shards", {}).items():
            for fname, meta in shard.get("files", {}).items():
                j = int(meta["range"])
                by_range.setdefault(j, []).append((int(rank_s) != j, fname, meta))
        missing = []
        for j, (a, b) in enumerate(buckets.shard_ranges(total, world, 1)):
            done = False
            for is_replica, fname, meta in sorted(
                by_range.get(j, []), key=lambda t: (t[0], t[1])
            ):
                full = os.path.join(sdir, fname)
                reason = _verify_range_file(full, meta, b - a)
                if reason is not None:
                    utils.log_error("checkpoint: %s", reason)
                    continue
                with open(full, "rb") as f:
                    buf[a:b] = f.read()
                if is_replica:
                    _M_RECONSTRUCTED.inc()
                    utils.log_info(
                        "checkpoint: step %d range %d rebuilt from replica "
                        "%s (primary lost)", int(step), j, fname,
                    )
                done = True
                break
            if not done:
                missing.append((j, a, b))
        if missing:
            raise MissingShardError(step, missing)
        blob = bytes(buf)
        got = hashlib.sha256(blob).hexdigest()
        if got != cohort["blob_sha256"]:
            raise ValueError(
                f"assembled blob checksum mismatch for step {step}: "
                f"expected {cohort['blob_sha256']}, got {got}"
            )
        return blob, cohort

    # ------------------------------------------------------------- internals
    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def _gc(self) -> None:
        committed = self.committed_steps()
        victims = committed[:-self.max_to_keep] if self.max_to_keep else []
        newest = committed[-1] if committed else None
        for s in victims:
            shutil.rmtree(self._step_path(s), ignore_errors=True)
        # Torn husks older than the newest committed checkpoint can never
        # become eligible — reap them (newer ones may be mid-write).
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if not name.startswith("step_"):
                continue
            base = name[:-len(".tmp")] if name.endswith(".tmp") else name
            try:
                s = int(base[len("step_"):])
            except ValueError:
                continue
            committed_here = os.path.exists(
                os.path.join(self.directory, name, _COHORT_MANIFEST)
            )
            if newest is not None and s < newest and not committed_here:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)


def _verify_range_file(full: str, meta: Dict[str, Any], want_size: int):
    """None when the range file matches its manifest entry; else the reason
    with path + expected/actual digests."""
    if not os.path.exists(full):
        return f"missing shard file {full}"
    size = os.path.getsize(full)
    if size != want_size:
        return f"truncated shard {full} ({size} != {want_size} bytes)"
    actual = _sha256(full)
    if actual != meta.get("sha256"):
        return (
            f"checksum mismatch on {full}: "
            f"expected {meta.get('sha256')}, got {actual}"
        )
    return None
