"""The Leung-Malik texture filter banks and the background subtraction
before them (frozen from the port's ``ops/filters``).

A bank's responses are ``F.conv2d`` of each channel with the flipped kernels
over a 'symmetric' padding (scipy's 'reflect'); the float32 reference runs
them with TF32 off (:mod:`portbench.reference.precision`).  The orientation
maximum is taken per battery, one battery's filters at a time, so the full
stack of responses never exists at once.
"""

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.frozen.ops.slic import _symmetric_index, gaussian_blur

#: sigmas of the full and short LM banks
DEFAULT_FILTERS_SIGMAS = (math.sqrt(2), 2.0, 2 * math.sqrt(2), 4.0)
SHORT_FILTERS_SIGMAS = (math.sqrt(2), 2.0, 4.0)

#: response clamp preventing overflow
MAX_SIGNAL_RESPONSE = 1.0e6


def _gaussian_1d(vals, sigma, order=0):
    response = np.exp(-vals ** 2 / (2.0 * sigma ** 2))
    if order == 1:
        response = -response * vals
    elif order == 2:
        response = response * (vals ** 2 - sigma ** 2)
    return response / np.abs(response).sum()


def _edge_filter_2d(sigma, phase, points, support):
    gx = _gaussian_1d(points[0, :], sigma=3 * sigma)
    gy = _gaussian_1d(points[1, :], sigma=sigma, order=phase)
    ft = (gx * gy).reshape(support, support)
    return ft / np.abs(ft).sum()


def _gaussian_2d(support, sigma, laplace=False):
    radius = support // 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g1 = np.exp(-0.5 * (x / sigma) ** 2)
    g1 /= g1.sum()
    if not laplace:
        return np.outer(g1, g1)
    # Laplacian of Gaussian from the separable second-derivative components
    gdd = (x ** 2 / sigma ** 4 - 1.0 / sigma ** 2) * g1
    return np.outer(gdd, g1) + np.outer(g1, gdd)


class FilterBank(NamedTuple):
    """Stacked kernels and the battery slicing."""
    kernels: np.ndarray        # (n_filters, support, support) float32
    battery_slices: tuple      # per battery: (start, stop) into n_filters
    names: tuple               # per battery name, e.g. 'sigma1.4-edge'


def create_filter_bank_lm_2d(radius=16, sigmas=DEFAULT_FILTERS_SIGMAS,
                             nb_orient=8) -> FilterBank:
    """The LM bank: per sigma, oriented edge and bar batteries, a Gaussian,
    and Laplacians of Gaussian at sigma and sigma**2."""
    support = 2 * radius + 1
    x, y = np.mgrid[-radius:radius + 1, radius:-radius - 1:-1]
    org_pts = np.vstack([x.ravel(), y.ravel()])

    kernels, slices, names = [], [], []

    def push(battery, name):
        slices.append((len(kernels), len(kernels) + len(battery)))
        kernels.extend(battery)
        names.append(name)

    for sigma in sigmas:
        edges, bars = [], []
        for orient in range(nb_orient):
            angle = np.pi * orient / nb_orient
            c, s = np.cos(angle), np.sin(angle)
            pts = np.dot(np.array([[c, -s], [s, c]]), org_pts)
            edges.append(_edge_filter_2d(sigma, 1, pts, support))
            bars.append(_edge_filter_2d(sigma, 2, pts, support))
        tag = 'sigma%.1f' % sigma
        push(edges, '%s-edge' % tag)
        push(bars, '%s-bar' % tag)
        push([_gaussian_2d(support, sigma)], '%s-Gauss' % tag)
        push([_gaussian_2d(support, sigma, laplace=True)], '%s-GaussLap' % tag)
        push([_gaussian_2d(support, sigma ** 2, laplace=True)],
             '%s-GaussLap2' % tag)
    return FilterBank(np.stack(kernels).astype(np.float32), tuple(slices),
                      tuple(names))


def filter_bank_raw(image, bank: FilterBank):
    """Orientation maxima of the bank's responses on every channel, without
    the response normalisation (linear per battery, so the descriptors
    apply it to their statistics).

    :param image: (H, W, C) float tensor (already background-subtracted)
    :returns: (n_batteries, H, W, C) f32 responses, clamped at
        ``MAX_SIGNAL_RESPONSE``
    """
    h, w, c = image.shape
    pad = bank.kernels.shape[-1] // 2
    dev = image.device
    x = image.to(torch.float32).permute(2, 0, 1)[:, None]     # (C, 1, H, W)
    x = torch.index_select(x, 2, torch.as_tensor(
        _symmetric_index(h, pad), device=dev))
    x = torch.index_select(x, 3, torch.as_tensor(
        _symmetric_index(w, pad), device=dev)).contiguous()
    # scipy's convolve flips the kernel relative to conv2d's correlation
    k = torch.as_tensor(np.ascontiguousarray(bank.kernels[:, ::-1, ::-1]),
                        device=dev)[:, None]                  # (F, 1, s, s)
    out = torch.empty((len(bank.names), h, w, c), dtype=torch.float32,
                      device=dev)
    for bi, (start, stop) in enumerate(bank.battery_slices):
        resp = F.conv2d(x, k[start:stop])                     # (C, n, H, W)
        r = torch.amax(resp, dim=1)
        out[bi] = torch.clamp_max(r, MAX_SIGNAL_RESPONSE).permute(1, 2, 0)
    return out


def battery_norm_scales(energy_totals):
    """(B,) scales ``log(1 + ||r||) / 0.03 / ||r||`` from each battery's
    raw response energy ``sum(r * r)`` over all pixels and channels; 0 for
    an all-zero battery."""
    norm = torch.sqrt(torch.clamp_min(energy_totals, 0.0))
    return torch.where(norm > 0, torch.log1p(norm) / 0.03
                       / torch.clamp_min(norm, 1e-30), 0.0)


def subtract_background(image, sigma=150.0, downsample=8):
    """``image - gaussian_filter(image, sigma)`` with the near-global blur
    taken at 1 / ``downsample`` resolution on the channel mean (the blur's
    channel kernel is uniform to ~1e-5 at this sigma) and upsampled
    bilinearly (half-pixel centres, edge samples held at the border, as
    ``jax.image.resize(..., 'linear')``).

    :param image: (H, W, C) float tensor
    """
    h, w, _ = image.shape
    ds = downsample
    chan = torch.mean(image.to(torch.float32), dim=-1, keepdim=True)
    ph, pw = (-h) % ds, (-w) % ds
    rows = torch.arange(h + ph, device=image.device).clamp_max(h - 1)
    cols = torch.arange(w + pw, device=image.device).clamp_max(w - 1)
    x = chan[rows][:, cols]                                   # edge padding
    hs, ws = x.shape[0] // ds, x.shape[1] // ds
    small = x.reshape(hs, ds, ws, ds, 1).mean(dim=(1, 3))
    small = gaussian_blur(small, sigma / ds)
    big = F.interpolate(small.permute(2, 0, 1)[None], size=(hs * ds, ws * ds),
                        mode='bilinear', align_corners=False)[0]
    return image - big.permute(1, 2, 0)[:h, :w]
