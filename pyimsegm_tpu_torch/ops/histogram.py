"""Label histograms in concentric annuli around positions, the
centre-detection features (port of ``pyimsegm_tpu.ops.histogram``).

The per-pixel disk counts of every label are computed once for each radius
(:func:`pyimsegm_tpu_torch.ops.morphology.disk_count_maps`) and the
positions gather from them; annulus differences and the ring normalisation
follow the reference, cropped element sizes at the border included.
"""

import torch

from pyimsegm_tpu_torch.ops.morphology import (  # noqa: F401
    disk_count_map,
    disk_count_maps,
)
from pyimsegm_tpu_torch.utils.device import as_tensor

#: concentric annuli radii (the reference calls them circle "diameters";
#: they are disk radii)
HIST_CIRCLE_DIAGONALS = (10, 20, 30, 40, 50)


def label_hist_maps(segm, nb_labels, diameters=HIST_CIRCLE_DIAGONALS):
    """Per-pixel label histogram maps for each disk radius.

    :param segm: (H, W) integer labels or (H, W, L) probability planes
    :returns: (counts (n_diam, L, H, W), sizes (n_diam, H, W)) f32
    """
    if segm.ndim == 2:
        planes = [(segm == lb).to(torch.float32) for lb in range(nb_labels)]
    else:
        planes = [segm[..., lb].to(torch.float32) for lb in range(nb_labels)]
    stack = torch.stack(planes + [torch.ones_like(planes[0])])  # (L+1, H, W)
    counts, sizes = [], []
    for d in diameters:
        m = disk_count_maps(stack, d)
        counts.append(m[:nb_labels])
        sizes.append(m[nb_labels])
    return torch.stack(counts), torch.stack(sizes)


def rings_at(counts, sizes, positions):
    """Annulus histograms at (P, 2) integer (row, col) positions, clipped
    to the image, from the maps of :func:`label_hist_maps`.

    :returns: (P, n_diam * L) f32
    """
    h, w = counts.shape[-2:]
    py = positions[:, 0].clamp(0, h - 1)
    px = positions[:, 1].clamp(0, w - 1)
    c_at = counts[:, :, py, px]                      # (n_diam, L, P)
    s_at = sizes[:, py, px]                          # (n_diam, P)
    feats = []
    prev_c = torch.zeros_like(c_at[0])
    prev_s = torch.zeros_like(s_at[0])
    for i in range(c_at.shape[0]):
        ring = (c_at[i] - prev_c) / torch.clamp_min(s_at[i] - prev_s,
                                                     1.0)[None]
        feats.append(ring.T)                         # (P, L)
        prev_c, prev_s = c_at[i], s_at[i]
    return torch.cat(feats, dim=1)


def compute_label_histograms_positions(segm, positions,
                                       diameters=HIST_CIRCLE_DIAGONALS,
                                       nb_labels=None, device='cuda'):
    """Annuli label histograms at (row, col) positions.

    :param segm: (H, W) integer labels or (H, W, L) probabilities; a tensor
        runs on its device, anything else on ``device``
    :param positions: (P, 2) positions, truncated to integers
    :returns: ((P, n_diam * L) f32 tensor, names)
    """
    segm = as_tensor(segm, device)
    if nb_labels is None:
        nb_labels = int(segm.max()) + 1 if segm.ndim == 2 else segm.shape[-1]
    counts, sizes = label_hist_maps(segm, nb_labels, tuple(diameters))
    pos = as_tensor(positions, segm.device).to(torch.int64)
    hists = rings_at(counts, sizes, pos)
    names = ['hist-d_%i-lb_%i' % (d, lb)
             for d in diameters for lb in range(nb_labels)]
    return hists, names
