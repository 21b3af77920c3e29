"""Host-side prioritized replay: the bit-exactness reference and RPC store.

The port of the JAX package's ``replay/host.py``, numpy as it is there, and
the reference the device store (:mod:`moolib_tpu_torch.replay.device`) is
held bit-exact against:

- :class:`SumTree` — numpy sum-tree, O(log n) vectorized updates.  The
  ``dtype`` parameter (default float64) lets tests run the reference in
  float32, the device store's dtype, so comparisons are exact.
- :class:`ReplayBuffer` — in-memory prioritized buffer (proportional
  sampling, PER importance weights), thread-safe, pytree items.
- :class:`ReplayServer` — add/sample/update_priorities/size over RPC.
  Handlers are registered ``inline=True``: numpy arguments arrive as
  zero-copy read-only views over the receive buffer, and the store copies
  each payload exactly once into buffer-owned memory.  Payload traffic is
  counted on ``replay_bytes_total{direction}``.
- :class:`ReplayClient` — call-through wrappers returning RPC futures.

Items may hold numpy arrays or torch tensors.  Sampling returns (batch,
indices, importance weights) with the standard PER correction
``w_i = (N * P(i))^-beta / max_j w_j``.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..rpc import Rpc
from ..utils import nest
from ._metrics import REPLAY_BYTES


def payload_bytes(tree: Any) -> int:
    """Total array bytes in a pytree of numpy arrays and torch tensors
    (non-array leaves count as zero)."""
    total = 0
    for leaf in nest.flatten(tree):
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def _own_copy(tree: Any) -> Any:
    """Copy borrowed array views into owned memory (one copy, at the only
    place the store retains data past the inline handler's return).  The
    codec lends numpy views over the receive buffer; its bfloat16 leaves
    arrive as tensors over a buffer of their own and are kept as they
    are."""
    return nest.map(
        lambda x: np.array(x, copy=True) if isinstance(x, np.ndarray) else x,
        tree,
    )


class SumTree:
    """Binary indexed sum-tree over fixed capacity (power of two internally)."""

    def __init__(self, capacity: int, dtype=np.float64):
        self.capacity = 1
        while self.capacity < capacity:
            self.capacity *= 2
        self.dtype = np.dtype(dtype)
        self.tree = np.zeros(2 * self.capacity, dtype=self.dtype)

    def set(self, idx, value) -> None:
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        value = np.atleast_1d(np.asarray(value, self.dtype))
        pos = idx + self.capacity
        self.tree[pos] = value
        # Walk the touched paths up, one vectorized level at a time.
        parents = np.unique(pos // 2)
        while parents[0] >= 1:
            self.tree[parents] = self.tree[2 * parents] + self.tree[2 * parents + 1]
            if parents[0] == 1:
                break
            parents = np.unique(parents // 2)

    def total(self) -> float:
        return float(self.tree[1])

    def get(self, idx) -> np.ndarray:
        return self.tree[np.asarray(idx, np.int64) + self.capacity]

    def sample(self, targets: np.ndarray) -> np.ndarray:
        """Find leaf indices whose prefix-sum interval contains each target."""
        idx = np.ones(len(targets), dtype=np.int64)
        t = np.asarray(targets, self.dtype).copy()
        while idx[0] < self.capacity:
            left = self.tree[2 * idx]
            go_right = t > left
            t = np.where(go_right, t - left, t)
            idx = 2 * idx + go_right
        return idx - self.capacity


def _numpy(x) -> np.ndarray:
    """Indices or priorities as numpy (a tensor leaves its device here)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ReplayBuffer:
    """Prioritized ring buffer of pytree items."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4, seed=None):
        self.capacity = int(capacity)
        self.alpha = alpha
        self.beta = beta
        self._tree = SumTree(self.capacity)
        self._items: List[Any] = [None] * self.capacity
        self._next = 0
        self._size = 0
        self._max_priority = 1.0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def size(self) -> int:
        return self._size

    def add(self, items: Sequence[Any], priorities: Optional[Sequence[float]] = None):
        """Insert items (list of pytrees); returns their slot indices."""
        with self._lock:
            n = len(items)
            if priorities is None:
                priorities = [self._max_priority] * n
            idxs = [(self._next + i) % self.capacity for i in range(n)]
            for i, item in zip(idxs, items):
                self._items[i] = item
            prios = np.maximum(np.asarray(_numpy(priorities), np.float64), 1e-6)
            self._max_priority = max(self._max_priority, float(prios.max()))
            self._tree.set(np.asarray(idxs), prios**self.alpha)
            self._next = (self._next + n) % self.capacity
            self._size = min(self._size + n, self.capacity)
            return idxs

    def sample(self, batch_size: int) -> Tuple[Any, np.ndarray, np.ndarray]:
        """(stacked batch, indices, importance weights)."""
        with self._lock:
            if self._size == 0:
                raise ValueError("replay buffer is empty")
            total = self._tree.total()
            # Stratified proportional sampling.
            seg = total / batch_size
            targets = (np.arange(batch_size) + self._rng.random(batch_size)) * seg
            idxs = self._tree.sample(np.minimum(targets, total * (1 - 1e-9)))
            # Guard slots never written (tree zero-padded region).
            idxs = np.clip(idxs, 0, max(self._size - 1, 0))
            probs = self._tree.get(idxs) / max(total, 1e-12)
            weights = (self._size * np.maximum(probs, 1e-12)) ** (-self.beta)
            weights = weights / weights.max()
            batch = nest.stack([self._items[int(i)] for i in idxs], dim=0)
            return batch, idxs.astype(np.int64), weights.astype(np.float32)

    def update_priorities(self, indices, priorities) -> None:
        with self._lock:
            prios = np.maximum(np.asarray(_numpy(priorities), np.float64), 1e-6)
            self._max_priority = max(self._max_priority, float(prios.max()))
            self._tree.set(np.asarray(_numpy(indices), np.int64), prios**self.alpha)


class ReplayServer:
    """Serve a ReplayBuffer to the cohort over RPC.

    All handlers run ``inline=True``: the add/update payloads arrive as
    borrowed zero-copy views over the receive buffer, and ``_on_add`` copies
    them exactly once into buffer-owned memory (the buffer outlives the
    frame).  The handlers only take the buffer's own short-lived lock, so
    they are safe on the transport's IO thread.
    """

    def __init__(self, rpc: Rpc, name: str, buffer: ReplayBuffer):
        self._rpc = rpc
        self._buffer = buffer
        self._name = name
        rpc.define(f"{name}.add", self._on_add, inline=True)
        rpc.define(f"{name}.sample", self._on_sample, inline=True)
        rpc.define(f"{name}.update_priorities", self._on_update, inline=True)
        rpc.define(f"{name}.size", self._buffer.size)

    def _on_add(self, items, priorities=None):
        REPLAY_BYTES.inc(payload_bytes(items), direction="add_in")
        items = [_own_copy(it) for it in items]
        if priorities is not None:
            priorities = np.array(priorities, copy=True)
        return self._buffer.add(items, priorities)

    def _on_sample(self, batch_size):
        batch, idxs, weights = self._buffer.sample(batch_size)
        REPLAY_BYTES.inc(payload_bytes(batch), direction="sample_out")
        return {"batch": batch, "indices": idxs, "weights": weights}

    def _on_update(self, indices, priorities):
        self._buffer.update_priorities(indices, priorities)
        return True


class ReplayClient:
    """Actor/learner-side handle to a remote ReplayServer."""

    def __init__(self, rpc: Rpc, server_peer: str, name: str):
        self._rpc = rpc
        self._peer = server_peer
        self._name = name

    def add_async(self, items, priorities=None):
        return self._rpc.async_(self._peer, f"{self._name}.add", items, priorities)

    def add(self, items, priorities=None):
        return self._rpc.sync(self._peer, f"{self._name}.add", items, priorities)

    def sample_async(self, batch_size: int):
        return self._rpc.async_(self._peer, f"{self._name}.sample", batch_size)

    def sample(self, batch_size: int):
        out = self._rpc.sync(self._peer, f"{self._name}.sample", batch_size)
        return out["batch"], out["indices"], out["weights"]

    def update_priorities_async(self, indices, priorities):
        return self._rpc.async_(
            self._peer, f"{self._name}.update_priorities", indices, priorities
        )

    def update_priorities(self, indices, priorities) -> None:
        """Fire-and-forget priority write-back (the learner never blocks)."""
        self.update_priorities_async(indices, priorities)

    def size(self) -> int:
        return self._rpc.sync(self._peer, f"{self._name}.size")
