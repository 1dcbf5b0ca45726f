"""Colour-space conversions from sRGB (port of the forward half of
``pyimsegm_tpu.ops.color``).

Elementwise PyTorch on the image's device; every function takes float
images in [0, 1] of shape (..., 3).  The inverse conversions come with a
later slice (ROADMAP.md item 9).
"""

import numpy as np
import torch

# sRGB <-> linear-RGB companding and the D65 RGB->XYZ matrix (IEC 61966-2-1).
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
# D65 reference white for CIE Lab / Luv.
_XN, _YN, _ZN = 0.95047, 1.0, 1.08883
# Ruifrok & Johnston H&E-DAB stain separation (rows = stains in RGB-OD).
_HED_FROM_RGB = np.linalg.inv(np.array([[0.65, 0.70, 0.29],
                                        [0.07, 0.99, 0.11],
                                        [0.27, 0.57, 0.78]], np.float64)
                              ).astype(np.float32)
_GRAY = np.array([0.2125, 0.7154, 0.0721], np.float32)


def _const(arr, like):
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def _cbrt(t):
    """Real cube root of a non-negative tensor (negative inputs give 0; the
    callers select another branch there)."""
    return torch.pow(torch.clamp_min(t, 0.0), 1.0 / 3.0)


def _srgb_to_linear(rgb):
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                       rgb / 12.92)


def rgb2xyz(rgb):
    lin = _srgb_to_linear(rgb)
    return lin @ _const(_RGB2XYZ, lin).T


def _lab_f(t):
    eps = (6.0 / 29.0) ** 3
    return torch.where(t > eps, _cbrt(t),
                       t / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)


def rgb2lab(rgb):
    xyz = rgb2xyz(rgb)
    fx = _lab_f(xyz[..., 0] / _XN)
    fy = _lab_f(xyz[..., 1] / _YN)
    fz = _lab_f(xyz[..., 2] / _ZN)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def rgb2luv(rgb):
    xyz = rgb2xyz(rgb)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    denom = x + 15.0 * y + 3.0 * z
    denom = torch.where(denom == 0, 1.0, denom)
    up = 4.0 * x / denom
    vp = 9.0 * y / denom
    un = 4.0 * _XN / (_XN + 15.0 * _YN + 3.0 * _ZN)
    vn = 9.0 * _YN / (_XN + 15.0 * _YN + 3.0 * _ZN)
    yr = y / _YN
    lum = torch.where(yr > (6.0 / 29.0) ** 3, 116.0 * _cbrt(yr) - 16.0,
                      (29.0 / 3.0) ** 3 * yr)
    u = 13.0 * lum * (up - un)
    v = 13.0 * lum * (vp - vn)
    return torch.stack([lum, u, v], dim=-1)


def rgb2hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    delta = v - mn
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(v == r, (g - b) / safe,
                    torch.where(v == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.where(delta == 0, 0.0, (h / 6.0) % 1.0)
    s = torch.where(v == 0, 0.0, delta / torch.where(v == 0, 1.0, v))
    return torch.stack([h, s, v], dim=-1)


def rgb2hed(rgb):
    od = -torch.log10(torch.clamp_min(rgb, 1e-6))
    return od @ _const(_HED_FROM_RGB, od).T


def rgb2gray(rgb):
    """ITU-R BT.601 luma weights (as ``skimage.color.rgb2gray``)."""
    return rgb @ _const(_GRAY, rgb)


#: conversions selectable by name in feature keys like ``color_lab``
CONVERT_FROM_RGB = {
    'rgb': lambda x: x,
    'xyz': rgb2xyz,
    'lab': rgb2lab,
    'luv': rgb2luv,
    'hsv': rgb2hsv,
    'hed': rgb2hed,
}


def convert_img_color_from_rgb(image, color_space):
    """Convert an RGB float image to the named colour space."""
    if color_space not in CONVERT_FROM_RGB:
        raise ValueError('unknown color space: %r (have %r)'
                         % (color_space, sorted(CONVERT_FROM_RGB)))
    return CONVERT_FROM_RGB[color_space](image)
