"""RPC payload serialization with out-of-band array buffers.

Counterpart of the reference's serializer stack (``src/serialization.h:1-461``,
``src/pythonserialization.h:43-423``, ``src/tensor.h:152-165``): python objects
are encoded with a tag-based fast path falling back to pickle, and tensors ride
*out of band* — only dtype/shape metadata goes in the payload stream while the
raw bytes are appended as separate buffers, so the transport can
scatter-gather them without copies.

The wire format is byte-compatible with the JAX package's, so a port peer and
a JAX peer can call each other.  Leaves may be ``torch.Tensor``: a tensor on
the card is staged through host memory and sent as kind ``"np"``, which any
peer decodes.  Received arrays come back as numpy, except bfloat16 leaves:
numpy has no bfloat16 of its own (``ml_dtypes`` is not required), so they
travel as raw 2-byte payloads under the ``"bfloat16"`` dtype tag and decode
to ``torch.bfloat16`` tensors via ``torch.frombuffer``.
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass, field
from typing import Any, List, Sequence

import numpy as np
import torch

_BF16_TAG = "bfloat16"


def _tensor_host(t: torch.Tensor):
    """(dtype tag, contiguous host ndarray) of a tensor leaf; bfloat16 is
    viewed as int16 so numpy can hold its raw 2-byte payload."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _BF16_TAG, t.view(torch.int16).numpy()
    arr = t.numpy()
    return _dtype_tag(arr.dtype), arr


@dataclass
class ArrayRef:
    """Metadata for one out-of-band array buffer."""

    dtype: str
    shape: tuple
    kind: str  # "np" | "jax" (the JAX package's accelerator leaf)
    data: Any = None  # bytes-like (only set on the wire side)


@dataclass
class SerializedPayload:
    payload: bytes = b""
    arrays: List[ArrayRef] = field(default_factory=list)

    def nbytes(self) -> int:
        return len(self.payload) + sum(
            a.data.nbytes if isinstance(a.data, memoryview) else len(a.data)
            for a in self.arrays
        )


class _Pickler(pickle.Pickler):
    """Pickler that diverts array leaves into the out-of-band table."""

    def __init__(self, file, arrays: List[ArrayRef]):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._arrays = arrays

    def persistent_id(self, obj):
        # np.asarray(order="C") forces contiguity like ascontiguousarray but
        # WITHOUT its documented at-least-1d promotion: a 0-d loss scalar
        # must come back 0-d, not shape (1,) (caught by the hypothesis
        # round-trip sweep in tests/test_serialization_props.py).
        # Structured dtypes (dtype.names) pickle inline: the ArrayRef wire
        # format encodes dtype by NAME, which cannot express field layouts.
        if (
            isinstance(obj, np.ndarray)
            and obj.dtype != object
            and obj.dtype.names is None
        ):
            arr = np.asarray(obj, order="C")
            self._arrays.append(ArrayRef(_dtype_tag(arr.dtype), arr.shape, "np", _raw_data(arr)))
            return ("__array__", len(self._arrays) - 1)
        if isinstance(obj, torch.Tensor):
            tag, host = _tensor_host(obj)
            self._arrays.append(ArrayRef(tag, tuple(obj.shape), "np", _raw_data(host)))
            return ("__array__", len(self._arrays) - 1)
        if isinstance(obj, (np.generic,)):
            # 0-dim numpy scalars pickle fine inline; keep them in-band.
            return None
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, arrays: Sequence[ArrayRef], borrow: bool = False):
        super().__init__(file)
        self._arrays = arrays
        self._borrow = borrow

    def persistent_load(self, pid):
        tag, idx = pid
        if tag != "__array__":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        ref = self._arrays[idx]
        arr = _materialize(ref, borrow=self._borrow)
        return arr


def _raw_data(arr: np.ndarray):
    """Contiguous raw bytes of an array; extension dtypes (bfloat16, fp8 from
    ml_dtypes) don't implement the buffer protocol, so view through uint8 —
    via a 1-d reshape, because numpy refuses itemsize-changing views of 0-d
    arrays (the shape travels separately in the ArrayRef)."""
    try:
        return arr.data
    except (ValueError, BufferError):
        return arr.reshape(-1).view(np.uint8).data


def _dtype_tag(dt: np.dtype) -> str:
    """Wire tag for a dtype: the typestr when it round-trips (lossless for
    byte order and str/bytes/void widths — dtype.NAME is not: '>i4' names
    as 'int32' and '<U3' as 'str96'), else the name, which resolves
    extension dtypes (bfloat16, fp8) via ml_dtypes on decode."""
    s = dt.str
    try:
        if np.dtype(s) == dt:
            return s
    except TypeError:
        pass
    return dt.name


def _materialize(ref: ArrayRef, borrow: bool = False):
    if ref.dtype == _BF16_TAG:
        # frombuffer over a copy: the receive buffer is transient.
        raw = bytearray(ref.data)
        if not raw:
            return torch.empty(ref.shape, dtype=torch.bfloat16)
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(ref.shape)
    arr = np.frombuffer(ref.data, dtype=np.dtype(ref.dtype)).reshape(ref.shape)
    if borrow:
        # Zero-copy: a read-only view straight over the receive buffer,
        # valid only as long as that buffer is (for RPC frames: the duration
        # of the handler call).  Callers opting in own the lifetime problem;
        # anything retained must be copied first.
        return arr
    # np.frombuffer gives a read-only view over the receive buffer; copy so
    # callers can mutate (the receive buffer is also about to be recycled).
    return arr.copy()


@dataclass
class NativePayload:
    """Payload produced by the native C++ codec (moolib_tpu_torch.native): header
    bytes + a list of contiguous ndarrays referenced out of band."""

    payload: bytes
    np_arrays: List[Any]

    def nbytes(self) -> int:
        return len(self.payload) + sum(a.nbytes for a in self.np_arrays)


def _native_codec():
    from .. import native

    return native.get_codec()


def serialize(obj: Any):
    """Serialize an arbitrary python object, extracting arrays out of band.

    Uses the native C++ codec when available (tag-based fast path); falls
    back to pickle with array extraction when there is no codec, or when a
    leaf needs the portable encoding (bfloat16 tensors).  Both produce
    self-describing wire bytes via :func:`pack`, so the choice is per
    message.
    """
    codec = _native_codec()
    if codec is not None:
        from ..native import NeedsPortableCodec

        try:
            header, arrays = codec.dumps(obj)
        except NeedsPortableCodec:
            return _py_serialize(obj)
        return NativePayload(header, arrays)
    return _py_serialize(obj)


def _py_serialize(obj: Any) -> SerializedPayload:
    arrays: List[ArrayRef] = []
    bio = io.BytesIO()
    _Pickler(bio, arrays).dump(obj)
    return SerializedPayload(bio.getvalue(), arrays)


_native_borrow_ok: Any = None  # None = unprobed; codec borrow support cache


def _probe_borrow(codec) -> bool:
    """Does this codec build accept ``loads(payload, arrays, borrow)``?
    Probed ONCE on a tiny sentinel round-trip — classifying a real
    payload's decode TypeError as "old codec" would silently disable the
    zero-copy path for the life of the process and mask the actual error."""
    global _native_borrow_ok
    if _native_borrow_ok is None:
        try:
            header, arrays = codec.dumps({"p": np.zeros(1, np.float32)})
            codec.loads(header, arrays, True)
            _native_borrow_ok = True
        except Exception:  # noqa: BLE001 - any sentinel failure: copy path
            _native_borrow_ok = False
    return _native_borrow_ok


def deserialize(sp, borrow: bool = False) -> Any:
    """Decode a payload back into python objects.

    ``borrow=True`` skips the defensive copy of numpy array leaves: they come
    back as read-only views straight over the receive buffer (zero payload
    bytes copied).  Only for callers that fully consume the arrays before the
    buffer is recycled — i.e. within the RPC handler call that received the
    frame (the bucketed gradient combine).  The copying default stays for
    user-facing RPC; bfloat16 leaves always copy.
    """
    global _native_borrow_ok
    if isinstance(sp, NativePayload):
        codec = _native_codec()
        if codec is None:  # built by a peer; we can't decode without it
            raise RuntimeError("native codec payload but codec unavailable")
        if borrow and _probe_borrow(codec):
            return codec.loads(sp.payload, sp.np_arrays, True)
        return codec.loads(sp.payload, sp.np_arrays)
    return _Unpickler(io.BytesIO(sp.payload), sp.arrays, borrow=borrow).load()


# ---------------------------------------------------------------------------
# Wire packing.  Body layout (all little-endian), first byte = codec id:
#
# codec 0 (python pickle path):
#   u8 0 | u32 payload_len | payload bytes | u16 n_arrays
#   per array: u8 kind | u16 dtype_len | dtype utf8 | u8 ndim | u64*ndim shape
#              | u64 data_len | data bytes
# codec 1 (native C++ codec; array metadata lives inside the header):
#   u8 1 | u32 header_len | header bytes | u16 n_arrays
#   per array: u64 data_len | data bytes
#
# The reference's equivalent is the iovec construction in
# ``src/transports/ipc.cc:61-98`` (header + payload + one iovec per tensor).
# A peer only sends codec 1 to a peer whose greeting said it can decode it.
# ---------------------------------------------------------------------------

_KINDS = {"np": 0, "jax": 1}
_KINDS_INV = {v: k for k, v in _KINDS.items()}


def pack(sp) -> List[bytes]:
    """Return a list of byte chunks (iovec-style) encoding the payload."""
    if isinstance(sp, NativePayload):
        chunks: List[bytes] = [struct.pack("<BI", 1, len(sp.payload)), sp.payload]
        chunks.append(struct.pack("<H", len(sp.np_arrays)))
        for a in sp.np_arrays:
            chunks.append(struct.pack("<Q", a.nbytes))
            chunks.append(_raw_data(a))
        return chunks
    chunks = [struct.pack("<BI", 0, len(sp.payload)), sp.payload]
    chunks.append(struct.pack("<H", len(sp.arrays)))
    for a in sp.arrays:
        dt = a.dtype.encode()
        hdr = struct.pack("<BH", _KINDS[a.kind], len(dt)) + dt
        hdr += struct.pack("<B", len(a.shape)) + struct.pack(f"<{len(a.shape)}Q", *a.shape)
        hdr += struct.pack("<Q", len(a.data) if not isinstance(a.data, memoryview) else a.data.nbytes)
        chunks.append(hdr)
        chunks.append(a.data)
    return chunks


def pack_bytes(sp: SerializedPayload) -> bytes:
    return b"".join(bytes(c) for c in pack(sp))


def unpack(buf, offset: int = 0):
    """Parse a packed body from ``buf`` (bytes/memoryview) starting at offset."""
    mv = memoryview(buf)
    (codec_id,) = struct.unpack_from("<B", mv, offset)
    offset += 1
    if codec_id == 1:
        (hlen,) = struct.unpack_from("<I", mv, offset)
        offset += 4
        header = bytes(mv[offset : offset + hlen])
        offset += hlen
        (narr,) = struct.unpack_from("<H", mv, offset)
        offset += 2
        buffers = []
        for _ in range(narr):
            (nbytes,) = struct.unpack_from("<Q", mv, offset)
            offset += 8
            buffers.append(mv[offset : offset + nbytes])
            offset += nbytes
        return NativePayload(header, buffers)
    (plen,) = struct.unpack_from("<I", mv, offset)
    offset += 4
    payload = bytes(mv[offset : offset + plen])
    offset += plen
    (narr,) = struct.unpack_from("<H", mv, offset)
    offset += 2
    arrays: List[ArrayRef] = []
    for _ in range(narr):
        kind, dlen = struct.unpack_from("<BH", mv, offset)
        offset += 3
        dtype = bytes(mv[offset : offset + dlen]).decode()
        offset += dlen
        (ndim,) = struct.unpack_from("<B", mv, offset)
        offset += 1
        shape = struct.unpack_from(f"<{ndim}Q", mv, offset) if ndim else ()
        offset += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", mv, offset)
        offset += 8
        data = mv[offset : offset + nbytes]
        offset += nbytes
        arrays.append(ArrayRef(dtype, tuple(shape), _KINDS_INV[kind], data))
    return SerializedPayload(payload, arrays)


def dumps(obj: Any) -> bytes:
    """One-shot: object → single bytes blob (payload + arrays)."""
    return pack_bytes(serialize(obj))


def dumps_portable(obj: Any) -> bytes:
    """One-shot using the always-available pickle codec — for handshakes that
    must parse before codec support is negotiated."""
    return pack_bytes(_py_serialize(obj))


def native_available() -> bool:
    return _native_codec() is not None


def loads(buf, borrow: bool = False) -> Any:
    """One-shot inverse of :func:`dumps`.  ``borrow=True`` returns numpy
    leaves as zero-copy views into ``buf`` (see :func:`deserialize`)."""
    return deserialize(unpack(buf), borrow=borrow)
