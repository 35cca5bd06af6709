"""Native TensorBoard event writer: no tensorboard package needed.

The port's copy of the scalar part of the JAX package's utils/tb_events.py
(images and the embedding projector are not ported yet). The reference logs
through torch's SummaryWriter (utils/train_one_epoch.py:90-101); this module
writes the TensorBoard on-disk format directly:

- events file = TFRecord stream of `Event` protobufs, each record framed as
  [len u64][masked crc32c(len) u32][payload][masked crc32c(payload) u32];
- `Event` / `Summary` protos are hand-encoded with the protobuf wire format
  (only the fields TensorBoard reads for a scalar).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# crc32c (Castagnoli), table-driven: TFRecord framing requires crc32c, which
# zlib does not provide (zlib.crc32 is the IEEE polynomial)
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# minimal protobuf wire encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_string(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


class EventWriter:
    """Append-only TensorBoard events file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        # Event { wall_time=1, file_version=3 }
        self._record(_f_double(1, time.time()) + _f_string(3, "brain.Event:2"))

    def _record(self, event_bytes: bytes):
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))

    def _event(self, summary: bytes, step: int):
        # Event { wall_time=1 (double), step=2 (int64), summary=5 (Summary) }
        self._record(_f_double(1, time.time()) + _f_varint(2, step) + _f_bytes(5, summary))

    def scalar(self, tag: str, value: float, step: int):
        # Summary.Value { tag=1, simple_value=2 (float) }
        val = _f_string(1, tag) + _f_float(2, float(value))
        self._event(_f_bytes(1, val), step)  # Summary { value=1 repeated }

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
