"""Native TensorBoard event writer: no tensorboard package needed.

The port's copy of the JAX package's utils/tb_events.py. The reference logs
through torch's SummaryWriter (utils/train_one_epoch.py:90-101,
utils/feature_extraction.py:43-45, visualization/custom_operation_checks.py:
49-52); this module writes the TensorBoard on-disk format directly:

- events file = TFRecord stream of `Event` protobufs, each record framed as
  [len u64][masked crc32c(len) u32][payload][masked crc32c(payload) u32];
- `Event` / `Summary` / `Summary.Image` protos are hand-encoded with the
  protobuf wire format (only the fields TensorBoard reads);
- images are PNG-encoded in pure Python (zlib deflate + PNG chunks);
- the embedding projector reads TSV tensors through
  `projector_config.pbtxt`, which needs no checkpoint.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Optional, Sequence

import numpy as np

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


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, {1,3}) uint8 -> PNG bytes."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"PNG supports 1 or 3 channels, got {c}")
    color_type = 0 if c == 1 else 2

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))  # filter 0 rows
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


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

    def image(self, tag: str, img: np.ndarray, step: int):
        """img: (H, W[, C]) uint8 or float in [0, 1]."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        # Summary.Image { height=1, width=2, colorspace=3, encoded=4 }
        image_pb = (
            _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
            + _f_bytes(4, encode_png(img))
        )
        val = _f_string(1, tag) + _f_bytes(4, image_pb)  # Value { image=4 }
        self._event(_f_bytes(1, val), step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def image_grid(images_nchw: np.ndarray, ncol: int = 8, pad: int = 2) -> np.ndarray:
    """(N, C, H, W) -> one (H', W', C) grid image in [0, 1] (torchvision's
    make_grid, which the reference relies on, without torchvision)."""
    x = np.asarray(images_nchw, np.float32)
    lo, hi = x.min(), x.max()
    x = (x - lo) / (hi - lo + 1e-12)
    n, c, h, w = x.shape
    ncol = min(ncol, n)
    nrow = -(-n // ncol)
    grid = np.zeros((c, nrow * (h + pad) + pad, ncol * (w + pad) + pad), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[
            :, pad + r * (h + pad): pad + r * (h + pad) + h,
            pad + col * (w + pad): pad + col * (w + pad) + w,
        ] = x[i]
    return grid.transpose(1, 2, 0)


def write_projector(
    log_dir: str,
    features: np.ndarray,
    labels: Optional[Sequence] = None,
    tag: str = "ssl_embedding",
):
    """The embedding projector through TSV tensors and
    projector_config.pbtxt, the projector plugin's checkpoint-free input
    (in place of SummaryWriter.add_embedding, reference
    feature_extraction.py:43-45)."""
    os.makedirs(log_dir, exist_ok=True)
    feats = np.asarray(features)
    tensor_file = f"{tag}_tensors.tsv"
    np.savetxt(os.path.join(log_dir, tensor_file), feats, delimiter="\t", fmt="%.6g")
    entry = [f'  tensor_name: "{tag}"', f'  tensor_path: "{tensor_file}"']
    if labels is not None:
        meta_file = f"{tag}_metadata.tsv"
        with open(os.path.join(log_dir, meta_file), "w") as f:
            f.write("\n".join(str(x) for x in labels) + "\n")
        entry.append(f'  metadata_path: "{meta_file}"')
    # idempotent on re-runs (extraction under --resume): drop any existing
    # block for this tag before appending the fresh one
    config_path = os.path.join(log_dir, "projector_config.pbtxt")
    blocks = []
    if os.path.exists(config_path):
        with open(config_path) as f:
            content = f.read()
        blocks = [
            b for b in content.split("embeddings {")
            if b.strip() and f'tensor_name: "{tag}"' not in b
        ]
    blocks.append("\n" + "\n".join(entry) + "\n}\n")
    with open(config_path, "w") as f:
        f.write("".join("embeddings {" + b for b in blocks))
