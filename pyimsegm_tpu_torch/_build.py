"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>_<hash>.so <name>.cu

The file name carries a hash of the source and of the shared headers
``csrc/*.cuh``, so an edited kernel is rebuilt
and a stale library is never loaded.  No PyTorch headers are compiled, which
keeps a build to seconds; :func:`build` compiles several sources at once.  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`launch` calls one on the tensor's device and
current stream and raises (:func:`check`) when that is not ``cudaSuccess``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'torch_kernels')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_LIBS = {}
#: seconds each library took to compile in this process (0.0 when the
#: library was already on disk); libraries built together overlap
BUILD_SECONDS = {}

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.isfile(path):
        return path
    raise RuntimeError('nvcc not found: the CUDA kernels build only where '
                       'the CUDA toolkit is installed')


def _paths(name):
    """(source, library path named by the hash of the source and of the
    shared headers ``csrc/*.cuh``)."""
    src = os.path.join(CSRC, name + '.cu')
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    return src, os.path.join(BUILD_DIR, 'lib%s_%s.so'
                             % (name, digest.hexdigest()[:16]))


def build(names):
    """Compile the libraries of ``names`` that are not on disk yet, one
    ``nvcc`` process each, all started together; record their seconds."""
    procs = {}
    for name in names:
        src, out = _paths(name)
        if name in BUILD_SECONDS or os.path.isfile(out):
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '%s.%d.tmp' % (out, os.getpid())
        procs[name] = (subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ['-o', tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, src,
            time.perf_counter())
    failed = []
    for name, (proc, tmp, out, src, t0) in procs.items():
        log = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append('nvcc failed on %s:\n%s' % (src, log))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('\n'.join(failed))


def load(name, signatures):
    """Compile (once) and load ``csrc/<name>.cu``.

    :param signatures: {C function name: list of ctypes argument types};
        every function returns an int (``cudaError_t``)
    :returns: the ``ctypes.CDLL``
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(_paths(name)[1])
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err, what):
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError('%s: CUDA launch failed with error %d' % (what, err))


def stream_ptr(tensor):
    """The current CUDA stream of the tensor's device, as a C pointer."""
    import torch
    return torch._C._cuda_getCurrentRawStream(tensor.device.index)


def launch(fn, what, tensor, *args):
    """Call the C entry point ``fn(*args, stream)`` on the device of
    ``tensor`` and its current stream (switching the current device only when
    it differs); raise when the launch returned a CUDA error."""
    import torch
    index = tensor.get_device()
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)


def require(tensor, name, dtype, shape=None):
    """Validate a kernel operand: on CUDA, dtype, shape, contiguous."""
    if not tensor.is_cuda:
        raise ValueError('%s must be a CUDA tensor' % name)
    if tensor.dtype != dtype:
        raise ValueError('%s must be %s, got %s' % (name, dtype, tensor.dtype))
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError('%s must have shape %s, got %s'
                         % (name, tuple(shape), tuple(tensor.shape)))
    if not tensor.is_contiguous():
        raise ValueError('%s must be contiguous' % name)
    return tensor
