"""Two-process replay smoke: memfd-multicast ingest + cohort sampling
across a real process boundary.

The port of the JAX package's ``scripts/replay_smoke.py``.  The parent
hosts the publisher Rpc (and one local shard service); a real child
process serves a second :class:`ReplayShardService` connected over the
parent's unix listener.  The parent multicasts a >1 MB trajectory batch to
both shards, which must take the write-once memfd path
(``multicast_ready`` true, ``replay_bytes_total{direction="ingest_out"}``
counted once per publish), then drives the two-level
:class:`DistributedReplay` draw over the cohort and routes priority
write-back to both shards.  Both shards are :class:`DeviceReplayShard`\\ s
on ``--device`` (no value: the card).

Gates (exit nonzero on any):

- multicast readiness over the fd-passing transport;
- write-once publish bytes (out == payload x publishes, not x consumers);
- both shards report their stripe (items partition round-robin);
- cohort draws return well-formed batches from BOTH shards across the
  process boundary, with weights max-normalized to 1;
- priority write-back moves both shards' reported totals.

Run it under ``MOOLIB_LOCKGRAPH=1``: the inline ingest handlers run on the
transport IO thread while drain/sample take the service lock from the
handler thread; an observed ABBA cycle in either process fails at teardown.

    MOOLIB_LOCKGRAPH=1 python -m moolib_tpu_torch.scripts.replay_smoke --smoke --device cpu
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np

from . import _soak

N_ITEMS = 32  # per publish; stripes split round-robin across 2 shards
PUBLISHES = 3


def _make_items(rng):
    # 32 x [21, 512] f32 ~ 1.4 MB: over the 1 MB memfd multicast floor.
    return [{"state": rng.normal(size=(21, 512)).astype(np.float32)} for _ in range(N_ITEMS)]


def child_main(addr: str, device: str) -> int:
    """The remote half of the cohort: shard 1, served until killed."""
    from .. import Rpc
    from ..replay import DeviceReplayShard, ReplayShardService

    rpc = Rpc()
    rpc.set_name("replay-smoke-shard1")
    ReplayShardService(rpc, "replay", DeviceReplayShard(256, name="smoke_shard1", device=device),
                       shard_index=1, num_shards=2)
    rpc.connect(addr)
    while True:  # the parent kills us when the smoke is done
        time.sleep(0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="(the only mode)")
    ap.add_argument("--device", default=None, help="torch device of both shards (default: cuda)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = _soak.device_arg(args.device)
    if args.child:
        return child_main(args.child, device)

    import torch

    from .. import Rpc, telemetry
    from ..replay import DeviceReplayShard, DistributedReplay, ReplayPublisher, ReplayShardService
    from ..replay.host import payload_bytes

    hub = Rpc()
    hub.set_name("replay-smoke-pub")
    hub.set_timeout(30)
    hub.listen(":0")
    addr = next(a for a in hub._listen_addrs if a.startswith("ipc://"))

    # Shard 0 lives in this process on its own Rpc (the same-process
    # loopback half); shard 1 is a REAL child process over the unix socket.
    spoke0 = Rpc()
    spoke0.set_name("replay-smoke-shard0")
    ReplayShardService(spoke0, "replay", DeviceReplayShard(256, name="smoke_shard0", device=device),
                       shard_index=0, num_shards=2)
    spoke0.connect(addr)
    child = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.scripts.replay_smoke", "--child", addr,
         "--device", device], env=_soak.child_env(), cwd=_soak.ROOT)
    fails = []

    def gate(ok, what):
        print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            fails.append(what)

    try:
        pub = ReplayPublisher(hub, ["replay-smoke-shard0", "replay-smoke-shard1"], "replay")
        deadline = time.monotonic() + 30
        while not pub.multicast_ready() and time.monotonic() < deadline:
            time.sleep(0.05)
        gate(pub.multicast_ready(), "multicast ready over fd-passing transport")

        rng = np.random.default_rng(0)
        items = _make_items(rng)
        per_publish = payload_bytes(items)
        gate(per_publish > 1024 * 1024, f"payload {per_publish} B over memfd floor")

        def counter(direction):
            vals = telemetry.get_registry().counter_values()
            return vals.get(f'replay_bytes_total{{direction="{direction}"}}', 0.0)

        out0 = counter("ingest_out")
        for _ in range(PUBLISHES):
            pub.publish(items).result(30)
        out_delta = counter("ingest_out") - out0
        gate(out_delta == per_publish * PUBLISHES,
             f"write-once publish bytes ({int(out_delta)} == {per_publish} x {PUBLISHES}, "
             "2 consumers)")

        rep = DistributedReplay(rpc=hub, remote_peers=["replay-smoke-shard0",
                                                       "replay-smoke-shard1"],
                                name="replay", seed=0)
        stats = rep.stats()  # stats drains both shards' pending stripes
        sizes = [int(st["size"]) for st in stats]
        gate(sizes == [PUBLISHES * N_ITEMS // 2] * 2, f"stripes partition the items ({sizes})")

        seen_shards = set()
        for _ in range(20):
            batch, ref, w = rep.sample(8)
            seen_shards.add(ref.shard)
            w = torch.as_tensor(w)
            if tuple(batch["state"].shape) != (8, 21, 512):
                gate(False, "cohort batch shape")
                break
            if abs(float(w.max()) - 1.0) > 1e-5:
                gate(False, "weights max-normalized")
                break
            rep.update_priorities(ref, np.full(8, 0.01, np.float32))
        else:
            gate(True, "20 cohort draws well-formed")
        gate(seen_shards == {0, 1}, f"draws hit both shards ({sorted(seen_shards)})")

        t_after = [float(st["total"]) for st in rep.stats()]
        t_start = [float(st["total"]) for st in stats]
        gate(all(a < s for a, s in zip(t_after, t_start)),
             f"priority write-back landed on both shards "
             f"({[round(t, 2) for t in t_start]} -> {[round(t, 2) for t in t_after]})")
    finally:
        child.kill()
        child.wait()
        spoke0.close()
        hub.close()
    if fails:
        print(f"replay_smoke: FAILED ({len(fails)} gate(s))", file=sys.stderr)
        return 1
    print(f"replay_smoke: OK (device={device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
