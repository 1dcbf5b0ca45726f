"""SLIC superpixels on a fixed seed grid, in PyTorch.

Port of ``pyimsegm_tpu.ops.slic``.  Seeds sit on a (gh, gw) grid with step
``sp_size``; each pixel competes among the 3x3 seeds around its own tile, so
K = gh * gw is fixed by the image shape and every later stage works on the
seed grid.

Dispatch goes by the tensor's device.  For a CUDA tensor
:func:`slic_segment`, :func:`slic_segment_with_geometry` and
:func:`slic_segment_with_features` run the hand-written kernels
(``ops/prep_cuda.py`` and ``ops/slic_cuda.py``); for a CPU tensor they run
the plain path (:func:`_slic_segment_xla`, named after the JAX function it
mirrors).  SLICO (adaptive per-cluster compactness) runs on both.

The Lab pixels are rounded through bf16 on both paths, as the reference
does on every backend, so both assign from the same pixel values.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from pyimsegm_tpu_torch.ops.color import rgb2lab  # noqa: F401
from pyimsegm_tpu_torch.utils.device import as_tensor

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


def _prepare_chw(image, cfg: SlicConfig):
    """bf16 (3, pad_h, pad_w) Lab planes + (gh, gw, 5) initial centres.

    The blur + rescale + Lab pass is :func:`prep_cuda.blur_lab`: the CUDA
    kernel for a CUDA image, its plain twin for a CPU image."""
    from pyimsegm_tpu_torch.ops.prep_cuda import blur_lab
    if image.ndim == 2:
        image = torch.stack([image] * 3, dim=-1)
    lab_chw = blur_lab(image)                        # (3, H, W) bf16
    return _edge_pad_chw(lab_chw, cfg), _seed_centers(lab_chw, cfg)


def _labels_geometry(labels, cfg: SlicConfig):
    """Counts + centres by one grid reduce over the label map."""
    from pyimsegm_tpu_torch.ops.grid import grid_segment_sum
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


def _slic_segment_xla(image, cfg: SlicConfig, compactness,
                      n_iter=DEFAULT_SLIC_ITERS, slico=False):
    """Plain SLIC (the JAX function of this name): n_iter-1 assign + update
    rounds, then a final assignment; with ``slico`` the distance is
    ``dc2 / M + ds2 / step**2`` with a per-cluster colour normaliser M.

    :returns: (H, W) int32 labels
    """
    from pyimsegm_tpu_torch.ops import slic_cuda
    lab = _prepare_image(image)
    lab_chw = lab.permute(2, 0, 1).to(torch.bfloat16)
    lab_p = _edge_pad_chw(lab_chw, cfg)
    centers = slic_cuda._slic_multi_update_plain(
        lab_p, _seed_centers(lab_chw, cfg), compactness, cfg,
        max(n_iter - 1, 0), slico)
    labels = slic_cuda._slic_assign_plain(lab_p, centers, compactness, cfg,
                                          slico)
    return labels[:cfg.height, :cfg.width].contiguous()


def _slic_segment_cuda(image, cfg: SlicConfig, compactness,
                       n_iter=DEFAULT_SLIC_ITERS, slico=False):
    """SLIC labels through the kernels: blur_lab, n_iter-1 assign + update
    rounds, then a labels-only final assignment."""
    from pyimsegm_tpu_torch.ops.slic_cuda import slic_assign, slic_multi_update
    lab_chw, centers0 = _prepare_chw(image, cfg)
    centers = slic_multi_update(lab_chw, centers0, compactness, cfg,
                                n_upd=max(n_iter - 1, 0), slico=slico)
    labels = slic_assign(lab_chw, centers, compactness, cfg, slico=slico)
    return labels[:cfg.height, :cfg.width].contiguous()


def slic_segment(image, cfg: SlicConfig, compactness,
                 n_iter=DEFAULT_SLIC_ITERS, slico=False):
    """Run SLIC; int32 labels of shape (height, width) in [0, K).

    :param image: (H, W, 3) or (H, W) float tensor (any scale); its device
        picks the kernels (CUDA) or the plain path (CPU)
    :param compactness: SLIC compactness m
    :param slico: adaptive per-cluster compactness (SLIC-zero)
    """
    if image.is_cuda:
        return _slic_segment_cuda(image, cfg, compactness, n_iter=n_iter,
                                  slico=slico)
    return _slic_segment_xla(image, cfg, compactness, n_iter=n_iter,
                             slico=slico)


def slic_segment_with_geometry(image, cfg: SlicConfig, compactness,
                               n_iter=DEFAULT_SLIC_ITERS):
    """SLIC labels plus per-superpixel pixel counts and (y, x) centres; on
    the card they come out of the final assignment pass.

    :returns: (labels (H, W) int32, counts (K,) f32, centres (K, 2) f32)
    """
    if image.is_cuda:
        return _slic_segment_geom_cuda(image, cfg, compactness, n_iter=n_iter)
    labels = _slic_segment_xla(image, cfg, compactness, n_iter=n_iter)
    counts, centers = _labels_geometry(labels, cfg)
    return labels, counts, centers


def _slic_segment_geom_cuda(image, cfg: SlicConfig, compactness,
                            n_iter=DEFAULT_SLIC_ITERS, feat_image=None):
    """SLIC through the kernels: blur_lab, n_iter-1 assign + update rounds,
    then one final assignment that also pools geometry (and the colour
    moments of ``feat_image``) and routes them to per-seed sums.

    :returns: (labels (H, W) i32, counts (K,), centres (K, 2)[, moment sums
        (K, 6)])
    """
    from pyimsegm_tpu_torch.ops.slic_cuda import (slic_multi_update,
                                                  slic_update_labels)
    lab_chw, centers0 = _prepare_chw(image, cfg)
    centers = slic_multi_update(lab_chw, centers0, compactness, cfg,
                                n_upd=max(n_iter - 1, 0))
    labels, _, sums = slic_update_labels(lab_chw, centers, compactness, cfg,
                                         feat=feat_image)   # (gh, gw, 6|12)
    k = cfg.n_segments
    counts = sums[..., 5].reshape(k)
    cent = (sums[..., 3:5] / torch.clamp_min(sums[..., 5:6], 1.0)).reshape(k, 2)
    labels = labels[:cfg.height, :cfg.width].contiguous()
    if feat_image is None:
        return labels, counts, cent
    return labels, counts, cent, sums[..., 6:12].reshape(k, 6)


def slic_segment_with_features(image, feat_image, cfg: SlicConfig,
                               compactness, n_iter=DEFAULT_SLIC_ITERS):
    """SLIC labels + geometry + per-superpixel colour moment sums.

    :param image: (H, W, 3) float tensor; its device picks the path
    :param feat_image: (H, W, 3) float image whose moments are wanted
    :returns: (labels (H, W) i32, counts (K,), centres (K, 2), moment sums
        (K, 6) = [sum v0, v1, v2, sum v0^2, v1^2, v2^2])
    """
    if image.is_cuda:
        return _slic_segment_geom_cuda(image, cfg, compactness, n_iter=n_iter,
                                       feat_image=feat_image)
    from pyimsegm_tpu_torch.ops.grid import grid_segment_sum
    labels = _slic_segment_xla(image, cfg, compactness, n_iter=n_iter)
    counts, centers = _labels_geometry(labels, cfg)
    feat = feat_image.to(torch.float32)
    sums = grid_segment_sum(torch.cat([feat, feat * feat], dim=-1), labels, cfg)
    return labels, counts, centers, sums


#: distance of a seed outside the grid (the reference's ``_BIG``)
_BIG = 1e10


def _slic_segment_skimage(image, cfg: SlicConfig, compactness,
                          n_iter=DEFAULT_SLIC_ITERS):
    """skimage-faithful SLIC iterations (the JAX package's
    ``_slic_segment_xla_skimage``), in plain PyTorch on the image's device:
    a 5x5 window of seeds around each pixel's tile, f32 Lab pixels (no bf16
    rounding), skimage's seeds (positions clipped into the image, colours
    at the rounded seed pixel), and empty clusters reset to zero on update.
    Each round is 25 passes over the image, one per window offset, and
    the update sums every offset's pixels by tile in a fixed order.

    :returns: (H, W) int32 raw grid labels in [0, K)
    """
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = image.device
    lab = _prepare_image(image)                      # (H, W, 3) f32
    rows = torch.arange(cfg.pad_h, device=dev).clamp_max(cfg.height - 1)
    cols = torch.arange(cfg.pad_w, device=dev).clamp_max(cfg.width - 1)
    lab_p = lab[rows][:, cols]
    hp, wp = cfg.pad_h, cfg.pad_w
    valid = ((torch.arange(hp, device=dev) < cfg.height)[:, None]
             & (torch.arange(wp, device=dev) < cfg.width)[None, :])
    valid = valid.to(torch.float32)
    py, px = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev),
                            torch.arange(wp, dtype=torch.float32, device=dev),
                            indexing='ij')

    cy0 = torch.clamp_max((torch.arange(gh, dtype=torch.float32, device=dev)
                           + 0.5) * step - 0.5, cfg.height - 1.0)
    cx0 = torch.clamp_max((torch.arange(gw, dtype=torch.float32, device=dev)
                           + 0.5) * step - 0.5, cfg.width - 1.0)
    iy = torch.clamp(torch.round(cy0).to(torch.int64), 0, cfg.height - 1)
    ix = torch.clamp(torch.round(cx0).to(torch.int64), 0, cfg.width - 1)
    init_color = lab[iy][:, ix]
    cyg, cxg = torch.meshgrid(cy0, cx0, indexing='ij')
    centers = torch.cat([init_color, cyg[..., None], cxg[..., None]], dim=-1)

    sw = (torch.tensor(compactness, dtype=torch.float32)
          / torch.tensor(step, dtype=torch.float32)) ** 2
    sw = float(sw)
    offsets = [(di, dj) for di in (-2, -1, 0, 1, 2)
               for dj in (-2, -1, 0, 1, 2)]
    ty = torch.arange(gh, device=dev)[:, None].expand(gh, gw)
    tx = torch.arange(gw, device=dev)[None, :].expand(gh, gw)
    data = torch.cat([lab_p, py[..., None], px[..., None],
                      torch.ones((hp, wp, 1), device=dev)],
                     dim=-1) * valid[..., None]

    def shift(grid, di, dj):
        """grid[y - di, x - dj], zero outside."""
        pad = [0, 0] * (grid.ndim - 2) + [max(dj, 0), max(-dj, 0),
                                          max(di, 0), max(-di, 0)]
        padded = torch.nn.functional.pad(grid, pad)
        return padded[max(-di, 0):max(-di, 0) + gh,
                      max(-dj, 0):max(-dj, 0) + gw]

    def assign(centers):
        best_d = torch.full((hp, wp), _BIG, dtype=torch.float32, device=dev)
        best_lb = torch.zeros((hp, wp), dtype=torch.int32, device=dev)
        best_o = torch.zeros((hp, wp), dtype=torch.int8, device=dev)
        for oi, (di, dj) in enumerate(offsets):
            sy, sx = ty + di, tx + dj
            inb = (sy >= 0) & (sy < gh) & (sx >= 0) & (sx < gw)
            nb = torch.roll(centers, (-di, -dj), dims=(0, 1))
            nb_id = torch.where(inb, sy * gw + sx, 0).to(torch.int32)
            nb = torch.where(inb[..., None], nb, _BIG)
            cfield = _upsample_grid(nb, step)
            lbf = _upsample_grid(nb_id[..., None], step)[..., 0]
            dl = lab_p - cfield[..., :3]
            dc2 = dl[..., 0] * dl[..., 0] + dl[..., 1] * dl[..., 1] \
                + dl[..., 2] * dl[..., 2]
            ds2 = (py - cfield[..., 3]) ** 2 + (px - cfield[..., 4]) ** 2
            d = dc2 + ds2 * sw
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_lb = torch.where(take, lbf, best_lb)
            best_o = torch.where(take, oi, best_o)
        return best_lb, best_o

    def update(best_o):
        sums = torch.zeros((gh, gw, 6), dtype=torch.float32, device=dev)
        for oi, (di, dj) in enumerate(offsets):
            part = (data * (best_o == oi)[..., None]) \
                .reshape(gh, step, gw, step, 6).sum(dim=(1, 3))
            sums = sums + shift(part, di, dj)
        # skimage's update: an empty cluster becomes zero
        return sums[..., :5] / torch.clamp_min(sums[..., 5:6], 1.0)

    for _ in range(max(n_iter - 1, 0)):
        _labels, best_o = assign(centers)
        centers = update(best_o)
    labels, _ = assign(centers)
    return labels[:cfg.height, :cfg.width].contiguous()


def segment_slic_img2d(img, sp_size=50, relative_compact=0.1, slico=False,
                       n_iter=DEFAULT_SLIC_ITERS, enforce_connectivity=True,
                       compat=False, device='cuda'):
    """SLIC label map of a 2D image, with the reference's parameters.

    :param img: (H, W[, 3]) image; a tensor runs on its device, anything
        else on ``device``
    :param enforce_connectivity: make every superpixel one 4-connected
        region and merge those below half a tile into a neighbour
    :param compat: the skimage-faithful mode (:func:`_slic_segment_skimage`
        on the device, then skimage's split, sequential relabel and merge
        on the host by the C++ union-find of
        :mod:`pyimsegm_tpu_torch.native`): the labels are component ids in
        raster order, their count depends on the image, and they are not on
        the seed grid
    :returns: (H, W) int32 numpy labels
    """
    img = as_tensor(img, device)
    cfg = slic_config(img.shape[0], img.shape[1], sp_size)
    m = compactness_from_regul(sp_size, relative_compact)
    if compat:
        if slico:
            raise ValueError('compat mode does not support slico')
        labels = _slic_segment_skimage(img, cfg, m, n_iter=n_iter)
        labels = labels.cpu().numpy().astype(np.int32)
        if enforce_connectivity:
            from pyimsegm_tpu_torch import native
            labels = native.enforce_connectivity(
                labels, min_size=int(0.5 * cfg.step * cfg.step))
        return labels
    labels = slic_segment(img, cfg, m, n_iter=n_iter, slico=slico)
    if enforce_connectivity:
        from pyimsegm_tpu_torch.ops.grid import enforce_grid_connectivity
        labels = enforce_grid_connectivity(
            labels, cfg, min_size=int(0.5 * cfg.step * cfg.step))
    return labels.cpu().numpy()
