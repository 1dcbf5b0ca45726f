"""Fused SLIC preprocessing: Gaussian blur + rescale + CIE Lab, bf16 out.

:func:`blur_lab` launches the CUDA kernel ``csrc/prep.cu`` for a CUDA tensor
and runs :func:`_blur_lab_plain` for a CPU tensor.  Both follow
``pyimsegm_tpu.ops.slic._prepare_image`` operation for operation (the TPU
kernel it replaces is ``pyimsegm_tpu.ops.prep_pallas.blur_lab_pallas``).
"""

import functools

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic import _gaussian_kernel1d, _prepare_image

_RADIUS = 4  # int(4 * sigma + 0.5) for sigma = 1, fixed in the kernel
#: launches of the CUDA kernel in this process
LAUNCHES = 0


@functools.cache
def _lib():
    return _build.load('prep', {'blur_lab': [_build.VOIDP] * 4
                                + [_build.INT] * 2 + [_build.VOIDP]})


def blur_lab(image):
    """(H, W, 3) float image (any scale) -> (3, H, W) bf16 Lab planes:
    sigma=1 symmetric Gaussian, min/max [0, 1] rescale, sRGB -> Lab.

    lo/hi are the global min/max of the raw image, taken with
    ``torch.aminmax`` outside the kernel."""
    image = image.to(torch.float32)
    if not image.is_cuda:
        return _blur_lab_plain(image)
    global LAUNCHES
    h, w = image.shape[:2]
    img = _build.require(image.contiguous(), 'image', torch.float32, (h, w, 3))
    lohi = torch.stack(torch.aminmax(img))
    taps = _gaussian_kernel1d(1.0, _RADIUS, img.device)
    out = torch.empty((3, h, w), dtype=torch.bfloat16, device=img.device)
    _build.launch(_lib().blur_lab, 'blur_lab', img, img.data_ptr(),
                  lohi.data_ptr(), taps.data_ptr(), out.data_ptr(), h, w)
    LAUNCHES += 1
    return out


def _blur_lab_plain(image):
    """Plain PyTorch twin of the kernel: (3, H, W) bf16."""
    return _prepare_image(image).permute(2, 0, 1).to(
        torch.bfloat16).contiguous()
