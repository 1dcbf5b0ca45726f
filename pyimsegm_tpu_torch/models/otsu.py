"""Multivariate Otsu thresholding (port of ``pyimsegm_tpu.models.otsu``):
per-dimension Otsu thresholds with sign-alignment voting across
dimensions."""

import torch


def threshold_otsu(values, weights=None, nbins=256):
    """Otsu threshold of a weighted 1D sample over a ``nbins`` histogram
    between its smallest and largest weighted value (the histogram's
    weights are 0/1 counts in the pipelines, so its sums are exact)."""
    if weights is None:
        weights = torch.ones_like(values)
    lo = torch.amin(torch.where(weights > 0, values, float('inf')))
    hi = torch.amax(torch.where(weights > 0, values, float('-inf')))
    span = torch.clamp_min(hi - lo, 1e-12)
    idx = torch.clamp(((values - lo) / span * nbins).to(torch.int32), 0,
                      nbins - 1)
    hist = torch.zeros(nbins, dtype=values.dtype, device=values.device) \
        .index_add_(0, idx, weights.to(values.dtype))
    centers = lo + (torch.arange(nbins, dtype=values.dtype,
                                 device=values.device) + 0.5) / nbins * span
    w1 = torch.cumsum(hist, 0)
    w2 = w1[-1] - w1
    s1 = torch.cumsum(hist * centers, 0)
    m1 = s1 / torch.clamp_min(w1, 1e-12)
    m2 = (s1[-1] - s1) / torch.clamp_min(w2, 1e-12)
    between = w1 * w2 * (m1 - m2) ** 2
    between = torch.where((w1 > 0) & (w2 > 0), between, -1.0)
    return centers[torch.argmax(between)]


def compute_multivariate_otsu(features, sample_weight=None):
    """(N,) int32 binary labels: each dimension thresholded by Otsu and
    flipped where that agrees better with the dimensions before it; a
    sample is 1 where most dimensions say so."""
    n, d = features.shape
    if sample_weight is None:
        sample_weight = torch.ones((n,), dtype=features.dtype,
                                   device=features.device)
    ys = torch.zeros((n, d), dtype=features.dtype, device=features.device)
    for i in range(d):
        thr = threshold_otsu(features[:, i], sample_weight)
        asign = (features[:, i] > thr).to(features.dtype)
        if i > 0:
            m = torch.mean(ys[:, :i], dim=1)
            d1 = torch.mean(torch.abs(asign - m) * sample_weight)
            d2 = torch.mean(torch.abs((1.0 - asign) - m) * sample_weight)
            asign = torch.where(d2 < d1, 1.0 - asign, asign)
        ys[:, i] = asign
    return (torch.mean(ys, dim=1) > 0.5).to(torch.int32)
