"""A lost greeting must not leave a half-open peer link.

Each side of a new connection sends its greeting once, when the connection
opens, and a side files the connection under the peer's name only when the
peer's greeting arrives.  If the dialer's greeting is lost, the acceptor
has the connection but no name for it, while the dialer holds it as the
acceptor's live link.  When the acceptor then dials back, the dialer keeps
the old link over the new one by the duplicate tie-break (the larger
``(initiator uid, dial sequence)`` wins) whenever its own uid is the
larger, and closes the new one: the acceptor can never reach the dialer.
This is the stall ``tests/test_torch_accumulator_rejoin.py`` saw under
frame chaos.  The port closes a connection that was never greeted
(``rpc.core._GREET_DEADLINE``), so the next dial wins and both peer tables
converge.
"""

import contextlib
import time

import pytest

from moolib_tpu_torch import Rpc
from moolib_tpu_torch.rpc import core as rpc_core

from conftest import grab_port


@pytest.fixture(params=["native", "asyncio"])
def transport(request, monkeypatch):
    if request.param == "asyncio":
        monkeypatch.setenv("MOOLIB_TPU_NATIVE_TRANSPORT", "0")
    return request.param


@contextlib.contextmanager
def drop_first_greeting(sender: Rpc):
    """Drop the first greeting ``sender`` sends, at the ``send_frame`` seam
    both transports share; every other frame passes."""
    dropped = []
    originals = [(cls, cls.__dict__["send_frame"])
                 for cls in (rpc_core._Connection, rpc_core._NativeConnection)]

    def wrap(orig):
        def send(conn, chunks):
            if (not dropped and getattr(conn, "rpc", None) is sender and chunks
                    and bytes(chunks[0][:1]) == bytes([rpc_core.KIND_GREETING])):
                dropped.append(conn)
                return None
            return orig(conn, chunks)
        return send

    for cls, orig in originals:
        cls.send_frame = wrap(orig)
    rpc_core.frame_seam_hooked = True
    try:
        yield dropped
    finally:
        for cls, orig in originals:
            cls.send_frame = orig
        rpc_core.frame_seam_hooked = False


def _linked(rpc: Rpc, name: str) -> bool:
    peer = rpc._peers.get(name)
    return peer is not None and any(not c.closed for c in peer.connections.values())


def _wait(cond, seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_lost_greeting_link_recovers(free_port, transport):
    a, b = Rpc(), Rpc()
    # The dialer must hold the larger uid, so that the tie-break keeps its
    # half-open link over the acceptor's dial back.
    dialer, acceptor = (a, b) if a._uid > b._uid else (b, a)
    try:
        dialer.set_name("dialer")
        acceptor.set_name("acceptor")
        acceptor.listen(f"127.0.0.1:{free_port}")
        dialer_addr = f"127.0.0.1:{grab_port()}"
        dialer.listen(dialer_addr)
        acceptor.define("echo", lambda x: x)
        dialer.define("echo", lambda x: x)
        acceptor.set_timeout(20)
        with drop_first_greeting(dialer) as dropped:
            dialer.connect(f"127.0.0.1:{free_port}")
            # The dialer files the link (the acceptor's greeting arrived);
            # the acceptor holds an open connection it has no name for.
            assert _wait(lambda: _linked(dialer, "acceptor"), 10)
            assert len(dropped) == 1 and not _linked(acceptor, "dialer")
            opened = time.monotonic()
            # The acceptor learns the dialer's address and calls it: its
            # dials lose the tie-break until the half-open link is gone.
            acceptor.connect(dialer_addr)
            fut = acceptor.async_("dialer", "echo", 7)
            assert fut.result(20) == 7
        waited = time.monotonic() - opened
        assert waited < rpc_core._GREET_DEADLINE + 5, waited
        # Both tables converge on one live link, and calls go both ways.
        assert _wait(lambda: _linked(dialer, "acceptor") and _linked(acceptor, "dialer"), 10)
        assert dialer.async_("acceptor", "echo", 8).result(20) == 8
    finally:
        a.close()
        b.close()
