"""SLIC superpixels on a fixed seed grid, in plain PyTorch (frozen from
the port's ``ops/slic``).  Seeds sit on a (gh, gw) grid with step
``sp_size``; each pixel competes among the 3x3 seeds around its own tile,
so K = gh * gw is fixed by the image shape and every later stage works on
the seed grid.  The Lab pixels are rounded through bf16, as the port does.
"""

import math
from typing import NamedTuple

import numpy as np
import torch


#: iterations of the reference SLIC (skimage ``max_num_iter=10``)
DEFAULT_SLIC_ITERS = 10


class SlicConfig(NamedTuple):
    """Static SLIC geometry for a given image shape and superpixel size."""
    height: int
    width: int
    step: int          # superpixel edge length in pixels
    grid_h: int        # number of seed rows
    grid_w: int        # number of seed cols
    pad_h: int         # padded image height (grid_h * step)
    pad_w: int         # padded image width  (grid_w * step)

    @property
    def n_segments(self) -> int:
        return self.grid_h * self.grid_w


def slic_config(height, width, sp_size) -> SlicConfig:
    """Seed-grid geometry: a ceil-divided grid of ``sp_size`` tiles that
    covers the image."""
    step = max(2, int(sp_size))
    gh = max(1, math.ceil(height / step))
    gw = max(1, math.ceil(width / step))
    return SlicConfig(height, width, step, gh, gw, gh * step, gw * step)


def compactness_from_regul(sp_size, sp_regul) -> float:
    """Reference parameter mapping: ``(sp_size * regul) ** 1.5``."""
    return float(sp_size * sp_regul) ** 1.5


def slic_weights(compactness, cfg: SlicConfig):
    """f32 distance weights ``(1 / step**2, m**2)`` of
    ``d = dc2 + ds2 * (1 / step**2) * m**2``, as python floats."""
    sw = np.float32(1.0) / np.float32(cfg.step) ** 2
    m2 = np.float32(compactness) ** 2
    return float(sw), float(m2)


def _gaussian_kernel1d(sigma, radius, device=None):
    """Gaussian taps computed in float64, rounded to f32."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.as_tensor((k / k.sum()).astype(np.float32), device=device)


def _symmetric_index(n, radius):
    """Source indices of numpy's 'symmetric' padding (edge repeated)."""
    idx = np.arange(-radius, n + radius)
    while (idx < 0).any() or (idx >= n).any():
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= n, 2 * n - idx - 1, idx)
    return idx


def gaussian_blur(image, sigma):
    """Separable Gaussian blur of an (H, W, C) image: tap radius
    ``int(4 * sigma + 0.5)``, symmetric padding, rows first; the taps of a
    pass are summed in order."""
    if sigma <= 0:
        return image
    radius = max(1, int(4.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, image.device)

    def conv_axis(arr, axis):
        n = arr.shape[axis]
        idx = torch.as_tensor(_symmetric_index(n, radius), device=arr.device)
        padded = torch.index_select(arr, axis, idx)
        out = None
        for t in range(2 * radius + 1):
            term = k[t] * padded.narrow(axis, t, n)
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(image, 0), 1)


def _div(t, c):
    """``t / c`` as a true division.  PyTorch's CUDA kernels turn division by
    a python scalar into a multiplication by its reciprocal, which rounds
    differently; a 0-dim device tensor divisor keeps the IEEE quotient."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _rgb2lab_explog(rgb):
    """sRGB -> Lab with ``x**2.4`` and ``cbrt`` written as exp/log, the forms
    the fused prep kernel uses; channel-last."""
    lin = []
    for c in range(3):
        v = torch.clamp(rgb[..., c], 0.0, 1.0)
        big = torch.exp(2.4 * torch.log(
            torch.clamp_min(_div(v + 0.055, 1.055), 1e-30)))
        lin.append(torch.where(v > 0.04045, big, _div(v, 12.92)))
    x = 0.412453 * lin[0] + 0.357580 * lin[1] + 0.180423 * lin[2]
    y = 0.212671 * lin[0] + 0.715160 * lin[1] + 0.072169 * lin[2]
    z = 0.019334 * lin[0] + 0.119193 * lin[1] + 0.950227 * lin[2]
    eps = (6.0 / 29.0) ** 3

    def lab_f(t):
        cbrt = torch.exp(_div(torch.log(torch.clamp_min(t, 1e-30)), 3.0))
        return torch.where(t > eps, cbrt,
                           _div(t, 3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)

    fx = lab_f(_div(x, 0.95047))
    fy = lab_f(y)
    fz = lab_f(_div(z, 1.08883))
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def _prepare_image(image):
    """Gray -> RGB, sigma=1 blur, [0, 1] rescale with the raw image's
    min/max (affine, so it commutes with the blur), Lab: (H, W, 3) f32."""
    if image.ndim == 2:
        image = torch.stack([image] * 3, dim=-1)
    image = image.to(torch.float32)
    lo, hi = torch.aminmax(image)
    blurred = gaussian_blur(image, 1.0)
    v = (blurred - lo) / torch.clamp_min(hi - lo, 1e-12)
    return _rgb2lab_explog(v)


def _upsample_grid(grid, step):
    """(gh, gw, F) -> (gh*step, gw*step, F) by tile replication."""
    gh, gw, f = grid.shape
    out = grid[:, None, :, None, :].expand(gh, step, gw, step, f)
    return out.reshape(gh * step, gw * step, f)


def _edge_pad_chw(arr, cfg: SlicConfig):
    """(C, H, W) -> (C, pad_h, pad_w), repeating the last row and column."""
    rows = torch.arange(cfg.pad_h, device=arr.device).clamp_max(cfg.height - 1)
    cols = torch.arange(cfg.pad_w, device=arr.device).clamp_max(cfg.width - 1)
    return arr[:, rows][:, :, cols].contiguous()


def _seed_centers(lab_chw_q, cfg: SlicConfig):
    """Initial (gh, gw, 5) centres: tile centres, colours sampled from the
    bf16 Lab of the unpadded image at the truncated, clipped seed pixel."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = lab_chw_q.device
    cy0 = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * step - 0.5
    cx0 = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * step - 0.5
    iy = cy0.to(torch.int64).clamp(0, cfg.height - 1)
    ix = cx0.to(torch.int64).clamp(0, cfg.width - 1)
    init_color = lab_chw_q[:, iy][:, :, ix].to(torch.float32).permute(1, 2, 0)
    cyg, cxg = torch.meshgrid(cy0, cx0, indexing='ij')
    return torch.cat([init_color, cyg[..., None], cxg[..., None]], dim=-1)


def _labels_geometry(labels, cfg: SlicConfig):
    """Counts + centres by one grid reduce over the label map."""
    from portbench.reference.frozen.ops.grid import grid_segment_sum
    h, w = labels.shape
    dev = labels.device
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    coords = torch.stack([torch.ones_like(py), py, px], dim=-1)
    sums = grid_segment_sum(coords, labels, cfg)
    counts = sums[:, 0]
    centers = sums[:, 1:] / torch.clamp_min(counts[:, None], 1.0)
    return counts, centers


def slic_segment(image, cfg: SlicConfig, compactness,
                 n_iter=DEFAULT_SLIC_ITERS):
    """SLIC: n_iter-1 assign + update rounds, then a final assignment.

    :param image: (H, W, 3) or (H, W) float tensor (any scale)
    :param compactness: SLIC compactness m
    :returns: (H, W) int32 labels in [0, K)
    """
    from portbench.reference.frozen.ops import slic_passes
    lab = _prepare_image(image)
    lab_chw = lab.permute(2, 0, 1).to(torch.bfloat16)
    lab_p = _edge_pad_chw(lab_chw, cfg)
    centers = slic_passes.slic_rounds(lab_p, _seed_centers(lab_chw, cfg),
                                      compactness, cfg, max(n_iter - 1, 0))
    labels = slic_passes.slic_labels(lab_p, centers, compactness, cfg)
    return labels[:cfg.height, :cfg.width].contiguous()


#: distance of a seed outside the grid (the reference's ``_BIG``)
_BIG = 1e10
