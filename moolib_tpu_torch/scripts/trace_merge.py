"""Stitch per-process Chrome traces into one cohort timeline.

The port of the JAX package's ``scripts/trace_merge.py`` (stdlib only).
Every process exports its own host trace (``host_trace.json``, or
``Tracer.export_chrome_trace``) with timestamps on its private
``perf_counter_ns`` origin and a ``metadata.clock_sync`` anchor; the port's
tracer writes the JAX package's format, so any mix of JAX and port host
traces merges.  This tool merges any number of them onto one unix-time
axis so a whole allreduce round or serve request reads as a single causal
tree across hosts:

1. **Rebase** each file's events to unix microseconds using its
   ``metadata.clock_sync`` anchor (captured once per Tracer).
2. **Skew-correct** residual per-host clock error NTP-style from the
   cross-process span pairs the RPC layer records: every ``rpc.recv`` span
   carries the ``span_id`` of the client's ``rpc.call`` span as its
   ``parent_id``, and the call span brackets the recv span in real time, so
   the midpoint difference estimates the pair's clock offset.  Offsets
   propagate through the pid graph breadth-first from the first file's pid.
3. **Link** cross-process parent/child edges as Chrome flow events
   (``ph: s``/``f``), which Perfetto draws as arrows between tracks.

``torch.profiler`` device traces are not inputs here: they feed the step
timeline (``telemetry.timeline``).

Usage::

    python -m moolib_tpu_torch.scripts.trace_merge --out merged.json run*/host_trace.json
    python -m moolib_tpu_torch.scripts.trace_merge --out merged.json --require-edges 1 ...

Prints one JSON stats line (files, events, traces, cross-process edges,
per-pid offsets).  ``--require-edges N`` exits non-zero when fewer
cross-process parent/child edges were found — the CI smoke gate.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Dict, List, Optional, Tuple


def load_trace(path: str) -> Tuple[List[dict], Optional[dict]]:
    """One exported trace: (events, clock_sync | None)."""
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    sync = (data.get("metadata") or {}).get("clock_sync")
    return events, sync


def _rebase(events: List[dict], sync: Optional[dict]) -> None:
    """Shift ts from the process-private perf_counter origin onto unix µs,
    in place.  Without an anchor the events stay on their own origin (they
    will cluster near zero — still loadable, just unaligned)."""
    if not sync:
        return
    # unix_us(ts) = (unix_ns + (ts_us * 1000 - perf_ns)) / 1000
    shift_us = (sync["unix_time_ns"] - sync["perf_counter_ns"]) / 1000.0
    for ev in events:
        if "ts" in ev:
            ev["ts"] += shift_us


def _span_key(ev: dict) -> Optional[str]:
    args = ev.get("args")
    if isinstance(args, dict):
        sid = args.get("span_id")
        if isinstance(sid, str):
            return sid
    return None


def _parent_key(ev: dict) -> Optional[str]:
    args = ev.get("args")
    if isinstance(args, dict):
        pid_ = args.get("parent_id")
        if isinstance(pid_, str):
            return pid_
    return None


def cross_edges(events: List[dict]) -> List[Tuple[dict, dict]]:
    """(parent_event, child_event) pairs whose pids differ."""
    by_span: Dict[str, dict] = {}
    for ev in events:
        key = _span_key(ev)
        if key is not None:
            # Duplicated ids across processes would corrupt edge-finding;
            # first writer wins (ids are 64-bit random — collisions are a
            # bug upstream, flagged in stats by the dropped count).
            by_span.setdefault(key, ev)
    edges = []
    for ev in events:
        pk = _parent_key(ev)
        if pk is None:
            continue
        parent = by_span.get(pk)
        if parent is not None and parent.get("pid") != ev.get("pid"):
            edges.append((parent, ev))
    return edges


def _midpoint(ev: dict) -> float:
    return ev.get("ts", 0.0) + ev.get("dur", 0.0) / 2.0


def skew_offsets(edges: List[Tuple[dict, dict]], root_pid) -> Dict[int, float]:
    """Per-pid residual clock offset (µs to SUBTRACT from that pid's ts),
    relative to ``root_pid``, from cross-process parent/child midpoints.

    For an edge client→server the call span brackets the recv span, so with
    synchronized clocks the midpoints coincide up to asymmetric network
    delay; the average midpoint difference over an edge set estimates the
    pair's offset (NTP's midpoint method with the RPC pair as the probe).
    Offsets compose breadth-first over the pid graph, so hosts that never
    talked directly still align through common peers."""
    pair_sum: Dict[Tuple[int, int], float] = collections.defaultdict(float)
    pair_n: Dict[Tuple[int, int], int] = collections.defaultdict(int)
    adj: Dict[int, set] = collections.defaultdict(set)
    for parent, child in edges:
        a, b = parent.get("pid"), child.get("pid")
        # offset of b's clock relative to a's: how far b's recv midpoint
        # sits from a's call midpoint.
        off = _midpoint(child) - _midpoint(parent)
        pair_sum[(a, b)] += off
        pair_n[(a, b)] += 1
        adj[a].add(b)
        adj[b].add(a)

    def pair_offset(a, b) -> float:
        """Mean offset of b relative to a, using both edge directions."""
        total, n = 0.0, 0
        if pair_n.get((a, b)):
            total += pair_sum[(a, b)]
            n += pair_n[(a, b)]
        if pair_n.get((b, a)):
            total -= pair_sum[(b, a)]
            n += pair_n[(b, a)]
        return total / n if n else 0.0

    offsets: Dict[int, float] = {root_pid: 0.0}
    frontier = [root_pid]
    while frontier:
        nxt = []
        for a in frontier:
            for b in adj.get(a, ()):
                if b in offsets:
                    continue
                offsets[b] = offsets[a] + pair_offset(a, b)
                nxt.append(b)
        frontier = nxt
    return offsets


def merge(paths: List[str], skew_correct: bool = True) -> Tuple[dict, dict]:
    """Merge exported traces; returns (chrome_trace_dict, stats_dict)."""
    all_events: List[dict] = []
    pids_seen: Dict[int, str] = {}
    next_fake_pid = [1 << 20]
    files = 0
    for path in paths:
        events, sync = load_trace(path)
        files += 1
        _rebase(events, sync)
        # Two files from the same numeric pid (different hosts, or a reused
        # pid) must not interleave on one track: remap the later one.
        file_pids = {ev.get("pid") for ev in events if "pid" in ev}
        remap = {}
        for p in file_pids:
            if p in pids_seen and pids_seen[p] != path:
                remap[p] = next_fake_pid[0]
                next_fake_pid[0] += 1
            else:
                pids_seen[p] = path
        if remap:
            for ev in events:
                if ev.get("pid") in remap:
                    ev["pid"] = remap[ev["pid"]]
        # Name each process track after its source file.
        for p in sorted({ev.get("pid") for ev in events if "pid" in ev}):
            all_events.append(
                {
                    "ph": "M",
                    "pid": p,
                    "tid": 0,
                    "name": "process_name",
                    "args": {"name": os.path.basename(os.path.dirname(path) or path)},
                }
            )
        all_events.extend(events)

    edges = cross_edges(all_events)
    offsets: Dict[int, float] = {}
    event_pids = {
        ev.get("pid")
        for ev in all_events
        if "ts" in ev and ev.get("pid") is not None
    }
    if skew_correct and edges:
        root_pid = edges[0][0].get("pid")
        offsets = skew_offsets(edges, root_pid)
        for ev in all_events:
            off = offsets.get(ev.get("pid"))
            if off and "ts" in ev:
                ev["ts"] -= off
        edges = cross_edges(all_events)  # re-find with corrected timestamps
    # A pid with no cross-process edge into the root's component gets no
    # skew estimate — it stays on its metadata.clock_sync anchor rebase
    # (already applied above) instead of failing the merge.  Counted so the
    # stats line shows how much of the timeline is anchor-accurate only.
    anchor_only = sorted(str(p) for p in event_pids if p not in offsets)

    # Flow events: one s→f arrow per cross-process edge.
    flow = []
    for i, (parent, child) in enumerate(edges):
        common = {"cat": "rpc", "name": "rpc", "id": i + 1}
        flow.append(
            {
                "ph": "s",
                "pid": parent["pid"],
                "tid": parent.get("tid", 0),
                "ts": parent.get("ts", 0.0),
                **common,
            }
        )
        flow.append(
            {
                "ph": "f",
                "bp": "e",
                "pid": child["pid"],
                "tid": child.get("tid", 0),
                "ts": child.get("ts", 0.0),
                **common,
            }
        )
    all_events.extend(flow)

    traces = set()
    spans = 0
    for ev in all_events:
        args = ev.get("args")
        if isinstance(args, dict) and "trace_id" in args:
            traces.add(args["trace_id"])
            spans += 1
    stats = {
        "files": files,
        "events": len(all_events),
        "spans_with_ids": spans,
        "traces": len(traces),
        "cross_process_edges": len(edges),
        "skew_offsets_us": {str(k): round(v, 1) for k, v in offsets.items()},
        "anchor_only_pids": len(anchor_only),
        "anchor_only": anchor_only,
    }
    return {"traceEvents": all_events, "displayTimeUnit": "ms"}, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+", help="per-process Chrome trace JSON files")
    ap.add_argument("--out", required=True, help="merged Chrome trace path")
    ap.add_argument(
        "--no-skew-correct",
        action="store_true",
        help="rebase on clock anchors only; skip the NTP-style residual pass",
    )
    ap.add_argument(
        "--require-edges",
        type=int,
        default=0,
        metavar="N",
        help="exit non-zero unless >= N cross-process parent/child edges",
    )
    args = ap.parse_args(argv)

    merged, stats = merge(args.inputs, skew_correct=not args.no_skew_correct)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, args.out)
    stats["out"] = args.out
    print(json.dumps(stats))
    if stats["cross_process_edges"] < args.require_edges:
        print(
            f"trace_merge: wanted >= {args.require_edges} cross-process edges, "
            f"found {stats['cross_process_edges']}",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
