"""Minimal NIfTI-1 reader (pure numpy + gzip).

A copy of ct_clip_ut_tpu/data/nifti.py (the port imports nothing of the
JAX package).

Replaces the reference's nibabel dependency (reference preprocess.py:8-18 —
`nib.load(...).get_fdata()`). Semantics match get_fdata: voxels decoded from
the Fortran-ordered data block into an (nx, ny, nz) array with the header's
scl_slope/scl_inter applied, as float64 cast to float32 by the caller.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def read_nii(path) -> np.ndarray:
    """Load a .nii / .nii.gz volume -> float64 array shaped (nx, ny, nz[, ...]),
    header scaling applied (nibabel get_fdata parity)."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)

    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr == 348:
        endian = "<"
    elif struct.unpack_from(">i", hdr, 0)[0] == 348:
        endian = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(f"{endian}8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from(f"{endian}h", hdr, 70)[0]
    vox_offset = int(struct.unpack_from(f"{endian}f", hdr, 108)[0])
    scl_slope = struct.unpack_from(f"{endian}f", hdr, 112)[0]
    scl_inter = struct.unpack_from(f"{endian}f", hdr, 116)[0]

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")

    out = data.astype(np.float64)
    if scl_slope not in (0.0,) and not np.isnan(scl_slope):
        if scl_slope != 1.0 or (scl_inter not in (0.0,) and not np.isnan(scl_inter)):
            inter = 0.0 if np.isnan(scl_inter) else scl_inter
            out = out * scl_slope + inter
    return out


def read_nii_data(file_path):
    """Error-swallowing wrapper matching reference preprocess.py:8-18
    (returns None on failure)."""
    try:
        return read_nii(file_path)
    except Exception as e:  # noqa: BLE001 — parity with reference behavior
        print(f"Error reading file {file_path}: {e}")
        return None


def write_nii(path, volume: np.ndarray, pixdim=(1.0, 1.0, 1.0)) -> None:
    """Write a minimal NIfTI-1 (.nii or .nii.gz) float32 volume — used by
    tests and tooling to fabricate fixtures."""
    volume = np.asarray(volume, np.float32)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = (volume.ndim,) + volume.shape + (1,) * (7 - volume.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 16)   # float32
    struct.pack_into("<h", hdr, 72, 32)   # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, *(1.0,) * (7 - len(pixdim)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    hdr[344:348] = b"n+1\x00"
    blob = bytes(hdr) + volume.tobytes(order="F")
    path = Path(path)
    if path.suffix == ".gz" or path.name.endswith(".nii.gz"):
        path.write_bytes(gzip.compress(blob))
    else:
        path.write_bytes(blob)
