"""Texture filter banks (Leung-Malik and Gabor), the background subtraction
before them, and local binary patterns (port of ``pyimsegm_tpu.ops.filters``).

The banks are built in numpy exactly as the JAX package builds them.  A
bank's responses are ``F.conv2d`` of each channel with the flipped kernels
over a 'symmetric' padding (scipy's 'reflect'), as the reference's
``conv_general_dilated``; TF32 is off (``pyimsegm_tpu_torch/__init__.py``),
so the convolution runs in full f32.  The orientation maximum is taken per
battery, one battery's filters at a time, so the full stack of responses
never exists at once (at 4096 x 4096 the 36 Gabor responses of three
channels would take 7.2 GB).
"""

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.ops.slic import _symmetric_index, gaussian_blur

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


def _gabor_kernel(sigma, theta, frequency, support):
    """Real Gabor kernel (cosine carrier), zero-DC within its envelope and
    normalised to unit L1."""
    radius = support // 2
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1].astype(np.float64)
    xr = x * np.cos(theta) + y * np.sin(theta)
    yr = -x * np.sin(theta) + y * np.cos(theta)
    env = np.exp(-(xr ** 2 + yr ** 2) / (2.0 * sigma ** 2))
    g = env * np.cos(2 * np.pi * frequency * xr)
    g -= g.sum() * env / max(env.sum(), 1e-12)
    return g / max(np.abs(g).sum(), 1e-12)


def create_filter_bank_gabor_2d(radius=16, sigmas=(2.0, 4.0),
                                frequencies=(0.1, 0.2, 0.3),
                                nb_orient=6) -> FilterBank:
    """The Gabor bank ('tGabor'): one battery per (sigma, frequency), the
    maximum over ``nb_orient`` orientations."""
    support = 2 * radius + 1
    kernels, slices, names = [], [], []
    for sigma in sigmas:
        for freq in frequencies:
            slices.append((len(kernels), len(kernels) + nb_orient))
            kernels.extend(_gabor_kernel(sigma, np.pi * o / nb_orient, freq,
                                         support) for o in range(nb_orient))
            names.append('sigma%.1f-freq%.2f-gabor' % (sigma, freq))
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


def filter_bank_response(image, bank: FilterBank):
    """Normalised bank responses: (n_batteries, H, W, C), each battery
    scaled by :func:`battery_norm_scales` over all its channels."""
    raw = filter_bank_raw(image, bank)
    scales = battery_norm_scales(torch.sum(raw * raw, dim=(1, 2, 3)))
    return raw * scales[:, None, None, None]


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


# ----------------------------------------------------------------- LBP ------

def lbp_codes(channel, uniform=True):
    """Per-pixel 8-neighbour local binary pattern codes (edge-replicated
    borders; a neighbour >= the pixel sets its bit).

    :param channel: (H, W) float tensor
    :returns: (H, W) int64 codes in [0, 256), or uniform bins in [0, 10):
        the number of set bits for patterns with at most two circular
        transitions, 9 otherwise
    """
    x = channel.to(torch.float32)
    h, w = x.shape
    xp = F.pad(x[None, None], (1, 1, 1, 1), mode='replicate')[0, 0]
    # neighbours in circular order starting east, counter-clockwise
    offs = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0),
            (1, 1)]
    bits = [(xp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] >= x).to(torch.int64)
            for dy, dx in offs]
    if not uniform:
        return sum(b << i for i, b in enumerate(bits))
    nset = sum(bits)
    trans = sum((bits[i] - bits[(i + 1) % 8]).abs() for i in range(8))
    return torch.where(trans <= 2, nset, 9)


def lbp_histogram_features(image, seg_ids, num_segments, uniform=True,
                           grid_ctx=None):
    """Per-superpixel normalised LBP histograms ('tLBP').

    In uniform mode the ``C * 10`` one-hot planes (bf16, exact for 0 / 1)
    ride one segment reduction (the grid reduce, row 6, over grid-structured
    labels), as the reference does.

    :param image: (H, W, C) float tensor
    :returns: ((num_segments, C * n_bins) features, names)
    """
    from pyimsegm_tpu_torch.ops.segment_stats import _reduce_sums
    image = image.to(torch.float32)
    c = image.shape[-1]
    n_bins = 10 if uniform else 256
    names = ['tLBP-ch%i_bin%i' % (ch + 1, b)
             for ch in range(c) for b in range(n_bins)]
    if uniform:
        onehot = torch.cat([F.one_hot(lbp_codes(image[..., ch]), n_bins)
                            .to(torch.bfloat16) for ch in range(c)], dim=-1)
        sums = _reduce_sums(onehot, seg_ids, num_segments, grid_ctx)
        sums = sums.reshape(num_segments, c, n_bins)
        total = torch.clamp_min(torch.sum(sums, dim=2, keepdim=True), 1.0)
        return (sums / total).reshape(num_segments, c * n_bins), names
    feats = []
    for ch in range(c):
        onehot = F.one_hot(lbp_codes(image[..., ch], uniform=False),
                           n_bins).to(torch.float32)
        sums = _reduce_sums(onehot, seg_ids, num_segments, grid_ctx)
        total = torch.clamp_min(torch.sum(sums, dim=1, keepdim=True), 1.0)
        feats.append(sums / total)
    return torch.cat(feats, dim=1), names
