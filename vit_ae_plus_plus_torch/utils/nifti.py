"""Minimal self-contained NIfTI-1 I/O (no nibabel dependency).

The port's copy of the JAX package's `utils/nifti.py`.

The reference's visualization path writes `.nii.gz` via nibabel
(visualization/visualizations.py:37-68) and medical users hold their volumes
in NIfTI; this module reads/writes the single-file NIfTI-1 format
(https://nifti.nimh.nih.gov/nifti-1) with the stdlib only, so NIfTI support
is never import-gated. Scope: single-file `.nii` / `.nii.gz`, the common
datatypes, 3-D/4-D images, scl_slope/scl_inter scaling, either endianness.
Orientation metadata (affines) is NOT interpreted — arrays round-trip in
voxel order; the writer emits an identity affine like the reference does
(`nib.Nifti1Image(vol, affine=np.eye(4))`).
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple, Union

import numpy as np

_HDR_SIZE = 348
_VOX_OFFSET = 352  # header + 4-byte extension flag
_MAGIC_OFFSET = 344

# NIfTI-1 datatype codes -> numpy dtypes (the common subset)
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODE_F32 = 16


def is_nifti(data: bytes) -> bool:
    """True when `data` is a (possibly gzipped) single-file NIfTI-1 blob."""
    if data[:2] == b"\x1f\x8b":
        import zlib

        try:  # stream-decompress just the header's worth
            data = zlib.decompressobj(31).decompress(data, _HDR_SIZE)
        except Exception:
            return False
    return len(data) >= _HDR_SIZE and data[_MAGIC_OFFSET:_MAGIC_OFFSET + 3] == b"n+1"


def _decode_header(hdr: bytes) -> Tuple[str, tuple, np.dtype, int, float, float]:
    """-> (byteorder, shape, dtype, vox_offset, slope, inter)."""
    for bo in ("<", ">"):
        (sizeof_hdr,) = struct.unpack(bo + "i", hdr[:4])
        if sizeof_hdr == _HDR_SIZE:
            break
    else:
        raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
    if hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 3] != b"n+1":
        raise ValueError("only single-file NIfTI-1 ('n+1' magic) is supported")
    dim = struct.unpack(bo + "8h", hdr[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack(bo + "h", hdr[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    (vox_offset,) = struct.unpack(bo + "f", hdr[108:112])
    slope, inter = struct.unpack(bo + "2f", hdr[112:120])
    return bo, shape, np.dtype(_DTYPES[datatype]), int(vox_offset), slope, inter


def read_nifti(src: Union[str, bytes]) -> np.ndarray:
    """Read a `.nii` / `.nii.gz` path or raw bytes -> float32 array in voxel
    order (x, y, z[, t]); scl_slope/scl_inter applied (slope 0 = unscaled,
    per the spec)."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    bo, shape, dtype, vox_offset, slope, inter = _decode_header(data[:_HDR_SIZE])
    n = int(np.prod(shape))
    arr = np.frombuffer(
        data, dtype=dtype.newbyteorder(bo), count=n, offset=vox_offset
    )
    # NIfTI data is Fortran-ordered over (x, y, z, ...)
    arr = arr.reshape(shape, order="F").astype(np.float32)
    # spec: slope == 0 means "no scaling at all" (inter included); NaN slope
    # appears in tool-written headers and means unscaled too (nibabel's read)
    if slope != 0.0 and not np.isnan(slope) and (slope != 1.0 or inter != 0.0):
        arr = arr * slope + (0.0 if np.isnan(inter) else inter)
    return arr


def write_nifti(path: str, array: np.ndarray) -> None:
    """Write a float32 single-file NIfTI-1 (`.nii`, or `.nii.gz` when the
    path ends in .gz) with unit pixdims and an identity orientation —
    exactly what the reference's nibabel call produces."""
    array = np.asarray(array, np.float32)
    if array.ndim > 7:
        raise ValueError(f"too many dims for NIfTI: {array.ndim}")
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [array.ndim] + list(array.shape) + [1] * (7 - array.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODE_F32)   # datatype
    struct.pack_into("<h", hdr, 72, 32)          # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, float(_VOX_OFFSET))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    # sform: identity orientation (srow_x/y/z @ 280/296/312, sform_code @ 254)
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<4f", hdr, 280, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 296, 0.0, 1.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, 1.0, 0.0)
    hdr[_MAGIC_OFFSET:_MAGIC_OFFSET + 4] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * (_VOX_OFFSET - _HDR_SIZE) + array.tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
