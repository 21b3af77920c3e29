"""The port's run-loop watchdog and flight recorder.

A section that outlives its deadline raises in its thread, dumps the
registry and the thread stacks, and — before the dump, as the JAX
package's watchdog does — records ``watchdog.expired`` in the process's
flight recorder, whose tail the dump prints.  The recorder itself is a
bounded ring mirrored into the span tracer.
"""

import time

import pytest

from moolib_tpu_torch import telemetry
from moolib_tpu_torch.telemetry import FlightRecorder, get_flight_recorder
from moolib_tpu_torch.watchdog import Watchdog, WatchdogTimeout


def test_fast_section_never_fires():
    wd = Watchdog(timeout=0.5, dump=False)
    try:
        for _ in range(3):
            with wd.section("fast"):
                time.sleep(0.01)
        time.sleep(0.3)  # give the monitor a chance to mis-fire
        assert wd.expired == []
    finally:
        wd.close()


def test_expiry_raises_in_armed_thread():
    wd = Watchdog(timeout=0.2, dump=False)
    try:
        with pytest.raises(WatchdogTimeout):
            with wd.section("wedged"):
                for _ in range(200):
                    time.sleep(0.02)
        assert wd.expired and wd.expired[0][0] == "wedged"
    finally:
        wd.close()


def test_expiry_is_in_the_flight_recorder_and_the_dump(capfd):
    """The expiry lands in get_flight_recorder() with the section, the
    watchdog's name and the timeout, and the dump's flight-recorder tail
    already shows it."""
    rec = get_flight_recorder()
    before = len(rec.events())
    fired = []
    wd = Watchdog(timeout=0.2, name="learner", on_expire=lambda s, t: fired.append(s))
    try:
        with wd.section("stuck"):
            time.sleep(0.6)
        _out, err = capfd.readouterr()
        assert fired == ["stuck"]
        new = [e for e in rec.events()[before:] if e[1] == "watchdog.expired"]
        assert len(new) == 1
        _t, name, args = new[0]
        assert args == {"watchdog": "learner", "section": "stuck", "timeout_s": 0.2}
        assert "telemetry dump" in err and "--- flight recorder" in err
        dump = err[err.index("telemetry dump"):]
        assert "watchdog.expired" in dump and "section=stuck" in dump
    finally:
        wd.close()


def test_flight_recorder_ring_and_tail():
    rec = FlightRecorder(capacity=3)
    assert "empty" in rec.format_tail()
    for i in range(5):
        rec.event("group.epoch", sync_id=i)
    names = [(n, a["sync_id"]) for _, n, a in rec.events()]
    assert names == [("group.epoch", 2), ("group.epoch", 3), ("group.epoch", 4)]
    tail = rec.format_tail(limit=2)
    assert "last 2 events" in tail and "sync_id=4" in tail and "sync_id=2" not in tail
    rec.clear()
    assert rec.events() == []
    telemetry.flight_event("test.mark", k=1)
    assert get_flight_recorder().events()[-1][1:] == ("test.mark", {"k": 1})
