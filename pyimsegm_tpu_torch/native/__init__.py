"""ctypes bindings of the native C++ host library (port of
``pyimsegm_tpu.native``).

The library is built from the port's own copy of the source,
``native/src/imsegm_native.cc``, at first use::

    g++ -O3 -fPIC -std=c++17 -shared \
        -o build/torch_native/libimsegm_native_<hash>.so imsegm_native.cc

The file name carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded.  When ``USE_NATIVE`` is set (the
default) a failed compile or load raises with the compiler's output; there
is no silent fallback.  With ``PYIMSEGM_USE_NATIVE=0``
:func:`enforce_connectivity` runs the numpy twin
(:func:`pyimsegm_tpu_torch.ops.connectivity_host.enforce_connectivity`) and
:func:`alpha_expansion` raises.

The functions accept numpy arrays or tensors (copied to the host) and return
numpy arrays.
"""

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

from pyimsegm_tpu_torch.utils.device import host_array

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'src', 'imsegm_native.cc')
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), 'build',
                          'torch_native')
_CXX_FLAGS = ['-O3', '-fPIC', '-std=c++17', '-shared']
_LIB = None

#: runtime toggle, like the reference's USE_CYTHON
USE_NATIVE = os.environ.get('PYIMSEGM_USE_NATIVE', '1') != '0'
#: seconds the library took to compile in this process (0.0 when it was
#: already on disk; None before the first load)
BUILD_SECONDS = None


def _lib_path():
    """The library's path, named by the hash of the source."""
    with open(_SRC, 'rb') as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, 'libimsegm_native_%s.so' % digest)


def _build(out):
    """Compile the source into ``out`` (through a temporary file, so a
    concurrent build never loads a partial library); raise with the
    compiler's output when it fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = '%s.%d.tmp' % (out, os.getpid())
    proc = subprocess.run(
        [os.environ.get('CXX', 'g++')] + _CXX_FLAGS + ['-o', tmp, _SRC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError('native build failed on %s:\n%s'
                           % (_SRC, proc.stdout))
    os.replace(tmp, out)


def _load():
    """Build (once) and load the library; None when ``USE_NATIVE`` is off."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None or not USE_NATIVE:
        return _LIB
    out = _lib_path()
    t0 = time.perf_counter()
    if not os.path.isfile(out):
        _build(out)
    BUILD_SECONDS = time.perf_counter() - t0
    try:
        lib = ctypes.CDLL(out)
    except OSError as exc:
        raise RuntimeError('native load failed on %s: %s' % (out, exc)) \
            from exc
    lib.enforce_connectivity_2d.restype = ctypes.c_int
    lib.enforce_connectivity_2d.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.alpha_expansion.restype = ctypes.c_double
    lib.alpha_expansion.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return _LIB


def has_native():
    """Whether the native library is in use (``USE_NATIVE`` on); builds and
    loads it, raising when that fails."""
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _host(x, dtype):
    return np.ascontiguousarray(host_array(x), dtype=dtype)


def enforce_connectivity(labels, min_size=16):
    """Relabel so every output label is one conn4-connected component; merge
    fragments smaller than ``min_size`` into a visited neighbour component
    (skimage's semantics: components relabel sequentially in raster order
    of their first pixel, a fragment joins the adjacent component it
    touches most, ties to the smallest output label).

    :param labels: (H, W) integer labels >= 0, array or tensor
    :returns: (H, W) int32 numpy labels (their count may differ from the
        input's)
    """
    labels = _host(labels, np.int32)
    lib = _load()
    if lib is None:
        from pyimsegm_tpu_torch.ops.connectivity_host import \
            enforce_connectivity as _twin
        return _twin(labels, min_size)
    h, w = labels.shape
    out = np.empty_like(labels)
    lib.enforce_connectivity_2d(_ptr(labels, ctypes.c_int32), h, w,
                                int(min_size), _ptr(out, ctypes.c_int32))
    return out


def alpha_expansion(edges, weights, unary, pairwise, init_labels=None,
                    n_iter=-1):
    """Exact multi-label MRF minimisation by alpha-expansion with Dinic
    max-flow (the host oracle of the device solvers).

    :param edges: (E, 2) int array or tensor
    :param weights: (E,) float
    :param unary: (N, C) float costs
    :param pairwise: (C, C) float costs
    :param init_labels: optional (N,) start labels in [0, C)
    :returns: (labels (N,) int32 numpy, energy float)
    """
    lib = _load()
    if lib is None:
        raise RuntimeError('native library disabled; alpha_expansion needs '
                           'the C++ library (unset PYIMSEGM_USE_NATIVE=0)')
    edges = _host(edges, np.int32)
    weights = _host(weights, np.float64)
    unary = _host(unary, np.float64)
    pairwise = _host(pairwise, np.float64)
    n, c = unary.shape
    labels = (np.argmin(unary, axis=1).astype(np.int32)
              if init_labels is None else _host(init_labels, np.int32).copy())
    # the C++ indexes nodes and labels with these, unchecked
    if edges.ndim != 2 or edges.shape[1] != 2 \
            or weights.shape != (len(edges),) or pairwise.shape != (c, c) \
            or labels.shape != (n,):
        raise ValueError('alpha_expansion: shapes edges %s, weights %s, '
                         'unary %s, pairwise %s, labels %s do not match'
                         % (edges.shape, weights.shape, unary.shape,
                            pairwise.shape, labels.shape))
    if (edges.size and (edges.min() < 0 or edges.max() >= n)) \
            or (n and (labels.min() < 0 or labels.max() >= c)):
        raise ValueError('alpha_expansion: an edge or a start label is out '
                         'of range')
    energy = lib.alpha_expansion(
        n, len(edges), c, _ptr(edges, ctypes.c_int32),
        _ptr(weights, ctypes.c_double), _ptr(unary, ctypes.c_double),
        _ptr(pairwise, ctypes.c_double), int(n_iter),
        _ptr(labels, ctypes.c_int32))
    return labels, float(energy)
