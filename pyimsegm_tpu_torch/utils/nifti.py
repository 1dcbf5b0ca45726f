"""Minimal self-contained NIfTI-1 reader / writer, host numpy (port of
``pyimsegm_tpu.utils.nifti``; no nibabel dependency).

Single-file ``.nii`` (or ``.nii.gz``) with the 348-byte NIfTI-1 header,
for the dtypes the converters of ``utils/data_io`` need (uint8, int16,
int32, float32, float64 and RGB24).
"""

import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_RGB24 = 128


def save_nifti(path, array, zooms=None):
    """Write an array as a single-file .nii (identity affine).

    RGB images (H, W, 3) uint8 are stored as RGB24; everything else keeps its
    dtype (float64 arrays are saved as float32).
    """
    arr = np.asarray(array)
    is_rgb = arr.ndim == 3 and arr.shape[-1] == 3 and arr.dtype == np.uint8
    if not is_rgb:
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in _CODES:
            arr = arr.astype(np.float32)
    dims = arr.shape[:-1] if is_rgb else arr.shape
    ndim = len(dims)
    datatype = _RGB24 if is_rgb else _CODES[np.dtype(arr.dtype)]
    bitpix = 24 if is_rgb else arr.dtype.itemsize * 8

    hdr = bytearray(348)
    struct.pack_into('<i', hdr, 0, 348)                      # sizeof_hdr
    dim = [ndim] + list(dims) + [1] * (7 - ndim)
    struct.pack_into('<8h', hdr, 40, *dim)
    struct.pack_into('<h', hdr, 70, datatype)
    struct.pack_into('<h', hdr, 72, bitpix)
    zooms = list(zooms or []) + [1.0] * 7
    struct.pack_into('<8f', hdr, 76, 1.0, *zooms[:7])        # pixdim
    struct.pack_into('<f', hdr, 108, 352.0)                  # vox_offset
    struct.pack_into('<f', hdr, 112, 1.0)                    # scl_slope
    struct.pack_into('<h', hdr, 252, 1)                      # qform_code
    # identity sform rows
    struct.pack_into('<h', hdr, 254, 1)
    struct.pack_into('<4f', hdr, 280, 1, 0, 0, 0)
    struct.pack_into('<4f', hdr, 296, 0, 1, 0, 0)
    struct.pack_into('<4f', hdr, 312, 0, 0, 1, 0)
    hdr[344:348] = b'n+1\x00'

    # NIfTI stores data Fortran-ordered over the spatial dims
    payload = np.asfortranarray(arr) if not is_rgb else \
        np.asfortranarray(arr.reshape(dims + (3,)))
    raw = payload.tobytes(order='F' if not is_rgb else 'A')
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'wb') as fp:
        fp.write(bytes(hdr))
        fp.write(b'\x00' * 4)                                # extension flag
        fp.write(raw)
    return str(path)


def load_nifti(path):
    """Read a single-file .nii(.gz); returns the array (C-ordered)."""
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'rb') as fp:
        data = fp.read()
    (size,) = struct.unpack_from('<i', data, 0)
    if size != 348:
        raise ValueError('not a NIfTI-1 file: %r' % path)
    dim = struct.unpack_from('<8h', data, 40)
    ndim = dim[0]
    dims = tuple(dim[1:1 + ndim])
    (datatype,) = struct.unpack_from('<h', data, 70)
    (vox_offset,) = struct.unpack_from('<f', data, 108)
    off = int(vox_offset)
    if datatype == _RGB24:
        arr = np.frombuffer(data, np.uint8, count=int(np.prod(dims)) * 3,
                            offset=off)
        return np.reshape(arr, dims + (3,), order='F').copy()
    dt = _DTYPES.get(datatype)
    if dt is None:
        raise ValueError('unsupported NIfTI datatype: %i' % datatype)
    arr = np.frombuffer(data, dt, count=int(np.prod(dims)), offset=off)
    return np.reshape(arr, dims, order='F').copy()
