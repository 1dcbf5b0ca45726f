"""Fused SLIC preprocessing: Gaussian blur + rescale + CIE Lab, bf16 out.

:func:`blur_lab` launches the CUDA kernels of ``csrc/prep.cu`` for a CUDA
tensor (a min / max reduction, then the blur + Lab pass) and runs
:func:`_blur_lab_plain` for a CPU tensor.  Both follow
``pyimsegm_tpu.ops.slic._prepare_image`` operation for operation (the TPU
kernel it replaces is ``pyimsegm_tpu.ops.prep_pallas.blur_lab_pallas``).
"""

import functools

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic import _gaussian_kernel1d, _prepare_image

_RADIUS = 4  # int(4 * sigma + 0.5) for sigma = 1, fixed in the kernel
#: (lo, hi) partials of the min / max launch (MM_BLOCKS of csrc/prep.cu)
_PARTS = 256
#: launches of the CUDA kernel in this process
LAUNCHES = 0


@functools.cache
def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('prep', {'blur_lab': [v] * 3 + [i] * 3 + [f] * 9
                                + [v]})


@functools.cache
def _taps():
    """The 9 blur taps as python floats, f32 values of
    ``_gaussian_kernel1d`` (float64, rounded once): passed by value, so a
    call copies nothing to the card."""
    return tuple(float(t) for t in _gaussian_kernel1d(1.0, _RADIUS).tolist())


def blur_lab(image):
    """(H, W, 3) float image (any scale) -> (3, H, W) bf16 Lab planes:
    sigma=1 symmetric Gaussian, min/max [0, 1] rescale, sRGB -> Lab.

    lo/hi are the global min/max of the raw image (NaN where a pixel is
    NaN), reduced on the card in the same C call."""
    image = image.to(torch.float32)
    if not image.is_cuda:
        return _blur_lab_plain(image)
    global LAUNCHES
    h, w = image.shape[:2]
    img = _build.require(image.contiguous(), 'image', torch.float32, (h, w, 3))
    parts = torch.empty((_PARTS, 2), dtype=torch.float32, device=img.device)
    out = torch.empty((3, h, w), dtype=torch.bfloat16, device=img.device)
    _build.launch(_lib().blur_lab, 'blur_lab', img, img.data_ptr(),
                  parts.data_ptr(), out.data_ptr(), h, w, _PARTS, *_taps())
    LAUNCHES += 1
    return out


def _blur_lab_plain(image):
    """Plain PyTorch twin of the kernel: (3, H, W) bf16."""
    return _prepare_image(image).permute(2, 0, 1).to(
        torch.bfloat16).contiguous()
