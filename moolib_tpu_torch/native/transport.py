"""ctypes binding for the native epoll transport (``native/transport.cc``).

One ``NativeNet`` per ``Rpc``: a C++ epoll thread owns every socket; Python
gets whole frames via callbacks (invoked on the epoll thread — the Rpc
marshals them onto its own engine thread).  Counterpart of the reference's
``poll::PollThread`` + ``ipc::Connection`` framing
(``src/transports/socket.cc:861-955``, ``src/transports/ipc.cc:51-232``).
"""

from __future__ import annotations

import ctypes
import os
import weakref
from typing import Callable, Optional

import numpy as np

from . import _build, _cache_dir, _source_hash, _SRC_DIR
from .. import utils

ACCEPT_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p)
FRAME_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int32,
)
CLOSE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)
CONNECT_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64)
RELEASE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)

_lib = None
_lib_tried = False


def _marshal_chunks(chunks):
    """Byte-like chunks → (ctypes bufs, lens, keep-alive objects)."""
    n = len(chunks)
    bufs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    keep = []
    for i, c in enumerate(chunks):
        if isinstance(c, bytes):
            keep.append(c)
            bufs[i] = ctypes.cast(ctypes.c_char_p(c), ctypes.c_void_p)
            lens[i] = len(c)
        else:
            mv = memoryview(c)
            if mv.ndim != 1 or mv.format != "B":
                mv = mv.cast("B")
            arr = np.frombuffer(mv, np.uint8)
            keep.append(arr)
            bufs[i] = ctypes.c_void_p(arr.ctypes.data)
            lens[i] = arr.nbytes
    return bufs, lens, keep


def get_lib():
    """The native transport library, or None (fallback to asyncio)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("MOOLIB_TPU_NO_NATIVE") == "1":
        return None
    src = os.path.join(_SRC_DIR, "transport.cc")
    if not os.path.exists(src):
        return None
    tag = _source_hash(src)
    out = os.path.join(_cache_dir(), f"libmoolib_net_{tag}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        if not _build(src, tmp, ("-pthread",)):
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        utils.log_error("native transport load failed: %s", e)
        return None
    lib.moolib_net_create.restype = ctypes.c_void_p
    lib.moolib_net_create.argtypes = [
        ACCEPT_CB,
        FRAME_CB,
        CLOSE_CB,
        CONNECT_CB,
        RELEASE_CB,
        ctypes.c_void_p,
    ]
    lib.moolib_net_listen_tcp.restype = ctypes.c_int
    lib.moolib_net_listen_tcp.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.moolib_net_listen_unix.restype = ctypes.c_int
    lib.moolib_net_listen_unix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.moolib_net_connect_tcp.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.moolib_net_connect_unix.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
    lib.moolib_net_send.restype = ctypes.c_int
    lib.moolib_net_send.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.moolib_net_send_iov.restype = ctypes.c_int
    lib.moolib_net_send_iov.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.moolib_net_send_memfd.restype = ctypes.c_int
    lib.moolib_net_send_memfd.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
    ]
    lib.moolib_net_send_memfd_multi.restype = ctypes.c_int32
    lib.moolib_net_send_memfd_multi.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
    ]
    lib.moolib_net_adopt.restype = ctypes.c_int64
    lib.moolib_net_adopt.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.moolib_net_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.moolib_net_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.moolib_net_conn_rx.restype = ctypes.c_uint64
    lib.moolib_net_conn_rx.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.moolib_net_conn_tx.restype = ctypes.c_uint64
    lib.moolib_net_conn_tx.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.moolib_net_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class NativeNet:
    """One native socket engine. Callbacks fire on the C++ epoll thread;
    callers must marshal onto their own thread and must NOT call
    ``destroy()`` from inside a callback (it joins the epoll thread)."""

    def __init__(
        self,
        on_accept: Callable[[int, str], None],
        on_frame: Callable[[int, bytes], None],
        on_close: Callable[[int], None],
        on_connect: Callable[[int, int], None],
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native transport unavailable")
        self._lib = lib

        # The CFUNCTYPE objects must outlive the engine: keep them on self.
        def _accept(ud, conn_id, transport):
            on_accept(conn_id, transport.decode())

        def _frame(ud, conn_id, datas, lens, n):
            # One callback per burst of frames (a single GIL acquisition
            # covers the whole batch).  Small frames are snapshotted with one
            # string_at memcpy — much cheaper than building a ctypes view
            # and free of lifetime constraints.  Large frames stay zero-copy
            # into the engine's read buffer, valid only for the duration of
            # this callback — consumers deserialize synchronously (array
            # leaves are copied during materialization).
            for i in range(n):
                length = lens[i]
                if length < 65536:
                    view = ctypes.string_at(datas[i], length) if length else b""
                else:
                    view = memoryview(
                        (ctypes.c_ubyte * length).from_address(datas[i])
                    ).cast("B")
                on_frame(conn_id, view)

        def _close(ud, conn_id):
            on_close(conn_id)

        def _connect(ud, req_id, conn_id):
            on_connect(req_id, conn_id)

        def _release(ud, token):
            # Unpin the buffers of a fully-written (or dropped) frame.
            self._pinned.pop(token, None)

        self._pinned: dict = {}
        self._token_counter = iter(range(1, 2**62))
        self.memfd_sends = 0  # frames that rode the zero-copy memfd path
        self._acb = ACCEPT_CB(_accept)
        self._fcb = FRAME_CB(_frame)
        self._ccb = CLOSE_CB(_close)
        self._ncb = CONNECT_CB(_connect)
        self._rcb = RELEASE_CB(_release)
        self._ctx = lib.moolib_net_create(
            self._acb, self._fcb, self._ccb, self._ncb, self._rcb, None
        )
        if not self._ctx:
            raise RuntimeError("moolib_net_create failed")

    def listen_tcp(self, host: str, port: int) -> int:
        """Returns the bound port (0 in ``port`` picks one), or raises."""
        if not self._ctx:
            raise OSError("engine destroyed")
        r = self._lib.moolib_net_listen_tcp(self._ctx, host.encode(), port)
        if r < 0:
            raise OSError(f"listen failed on {host}:{port}")
        return r

    def listen_unix(self, path: str) -> None:
        if not self._ctx:
            raise OSError("engine destroyed")
        if self._lib.moolib_net_listen_unix(self._ctx, path.encode()) < 0:
            raise OSError(f"listen failed on {path}")

    def connect_tcp(self, req_id: int, host: str, port: int) -> None:
        if self._ctx:
            self._lib.moolib_net_connect_tcp(self._ctx, req_id, host.encode(), port)

    def connect_unix(self, req_id: int, path: str) -> None:
        if self._ctx:
            self._lib.moolib_net_connect_unix(self._ctx, req_id, path.encode())

    def send(self, conn_id: int, data) -> bool:
        """Queue one frame (the engine adds the length prefix). Any thread."""
        if not self._ctx:
            return False
        if not isinstance(data, bytes):
            data = bytes(data)
        return self._lib.moolib_net_send(self._ctx, conn_id, data, len(data)) == 0

    def send_iov(self, conn_id: int, chunks) -> bool:
        """Gather-send one frame from byte-like chunks — the analogue of the
        reference's iovec sends. Small chunks are copied into the engine;
        large ones ride zero-copy, pinned here until the engine reports the
        frame written (release callback). Callers must treat large chunk
        buffers as immutable until then (same contract as the reference's
        refcounted tensor buffers on the wire)."""
        if not self._ctx:
            return False
        # Small frames: one join + one primitive-args ctypes call — the
        # iov/pin machinery costs ~15us per call, pure overhead below the
        # zero-copy threshold where nothing can pin anyway.
        total = 0
        for c in chunks:
            total += len(c) if isinstance(c, bytes) else memoryview(c).nbytes
            if total >= 65536:
                break
        if total < 65536:
            data = b"".join(
                c if isinstance(c, bytes) else bytes(c) for c in chunks
            )
            return self._lib.moolib_net_send(self._ctx, conn_id, data, len(data)) == 0
        # keep: buffer-exporting objects; pinned if the engine borrows.
        bufs, lens, keep = _marshal_chunks(chunks)
        token = next(self._token_counter)
        # Publish the pin before the call: the epoll thread can finish the
        # write (and fire release) before moolib_net_send_iov returns.
        self._pinned[token] = keep
        rc = self._lib.moolib_net_send_iov(
            self._ctx, conn_id, bufs, lens, len(chunks), token
        )
        if rc != 1:  # fully copied (or error): nothing stays borrowed
            self._pinned.pop(token, None)
        # rc -2 = conn unknown/closed at the engine: the frame did NOT go
        # out — callers must treat it as a dead connection, not a success.
        return rc >= 0

    def send_memfd(self, conn_id: int, chunks) -> bool:
        """Same-host zero-copy send: the frame payload is written into an
        anonymous memfd; only a 12-byte control frame + the fd (SCM_RIGHTS)
        cross the unix socket, and the receiver mmaps the payload. The write
        into the memfd completes synchronously, so nothing is pinned."""
        if not self._ctx:
            return False
        bufs, lens, keep = _marshal_chunks(chunks)
        ok = (
            self._lib.moolib_net_send_memfd(self._ctx, conn_id, bufs, lens, len(chunks))
            == 0
        )
        del keep  # the memfd write completed synchronously inside the call
        if ok:
            self.memfd_sends += 1
        return ok

    def send_memfd_multi(self, conn_ids, chunks) -> int:
        """Multicast one frame to several same-host peers: the payload is
        written into ONE anonymous memfd and a dup of the fd rides to every
        connection (receivers mmap the same pages).  Returns how many
        connections the frame was queued to — the caller retries the missed
        ones individually (receiver-side rid dedup makes that safe).  The
        write completes synchronously, nothing is pinned."""
        if not self._ctx or not conn_ids:
            return 0
        bufs, lens, keep = _marshal_chunks(chunks)
        ids = (ctypes.c_int64 * len(conn_ids))(*conn_ids)
        sent = self._lib.moolib_net_send_memfd_multi(
            self._ctx, ids, len(conn_ids), bufs, lens, len(chunks)
        )
        del keep
        if sent:
            self.memfd_sends += sent
        return int(sent)

    def adopt_frame(self, frame) -> "np.ndarray | None":
        """Adopt the memfd mapping behind ``frame`` (a zero-copy memoryview
        delivered by the CURRENT frame callback, on the callback thread):
        ownership of the pages transfers here, and the returned uint8 array
        stays valid for its own lifetime — munmap runs when the array is
        garbage collected.  Returns None when the frame is not an adoptable
        mapping (small copied frames, TCP frames, asyncio transport)."""
        if not self._ctx or not isinstance(frame, memoryview):
            return None
        obj = frame.obj
        if not isinstance(obj, ctypes.Array):
            return None
        addr = ctypes.addressof(obj)
        size = self._lib.moolib_net_adopt(self._ctx, ctypes.c_void_p(addr))
        if size < 0:
            return None
        arr_t = (ctypes.c_ubyte * size).from_address(addr)
        out = np.frombuffer(arr_t, np.uint8)
        # The mapping is PROT_READ; numpy must not let anyone write into it.
        out.flags.writeable = False
        weakref.finalize(arr_t, self._lib.moolib_net_unmap,
                         ctypes.c_void_p(addr), size)
        return out

    def close_conn(self, conn_id: int) -> None:
        if self._ctx:
            self._lib.moolib_net_close_conn(self._ctx, conn_id)

    def conn_rx(self, conn_id: int) -> int:
        """Monotonic received-byte count for a live connection (0 if gone)."""
        if not self._ctx:
            return 0
        return self._lib.moolib_net_conn_rx(self._ctx, conn_id)

    def conn_tx(self, conn_id: int) -> int:
        """Monotonic written-byte count for a live connection (0 if gone)."""
        if not self._ctx:
            return 0
        return self._lib.moolib_net_conn_tx(self._ctx, conn_id)

    def destroy(self) -> None:
        ctx, self._ctx = self._ctx, None
        if ctx:
            self._lib.moolib_net_destroy(ctx)
