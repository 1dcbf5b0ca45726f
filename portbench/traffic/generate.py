"""The one generator of every traffic mix: a mix file names a ``kind`` and
its parameters, and :func:`make_item` draws one item of it from a seed.

Kinds:

* ``tissue_tiles``: RGB float32 tiles in [0, 1] of Voronoi regions, each of
  one class, each class with its own colour and an oriented sinusoidal
  texture, plus Gaussian noise; the ground truth is the class map.
* ``blob_volumes``: gray float32 volumes of blobs (a coarse Gaussian field
  upsampled trilinearly and thresholded, as nuclei in a confocal stack) of
  one intensity over a background of another, plus Gaussian noise; the
  ground truth is the blob mask.

Every item of one mix has the same shape and the same number of regions or
the same field grid, whatever the seed: seeds change the content, not the
amount of work.  Items are drawn with a ``torch.Generator`` on the device
that makes them (the card in a run), in a few large calls.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def item_seed(seed, index):
    """A 63-bit generator seed mixed from the run's seed and an item's
    index in its pool."""
    lo, hi = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), int(index)]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def _tissue_tile(mix, gen, device):
    h, w = mix['shape']
    n_reg = int(mix['regions'])
    classes = mix['classes']
    u = torch.rand((n_reg, 3), generator=gen, device=device)
    seeds_yx = u[:, :2] * torch.tensor([h, w], dtype=torch.float32,
                                       device=device)
    region_class = torch.randint(0, len(classes), (n_reg,), generator=gen,
                                 device=device)
    phase = u[:, 2] * (2 * math.pi)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    region = torch.empty((h, w), dtype=torch.int64, device=device)
    rows = max(1, (1 << 24) // max(w * n_reg, 1))
    for r0 in range(0, h, rows):
        dy = (ys[r0:r0 + rows, None, None] - seeds_yx[None, None, :, 0]) ** 2
        dx = (xs[None, :, None] - seeds_yx[None, None, :, 1]) ** 2
        region[r0:r0 + rows] = torch.argmin(dy + dx, dim=-1)
    truth = region_class[region]
    colour = torch.tensor([c['rgb'] for c in classes], dtype=torch.float32,
                          device=device)
    theta = torch.tensor([math.radians(c['orientation_deg'])
                          for c in classes], device=device)
    freq = torch.tensor([c['frequency'] for c in classes], device=device)
    amp = torch.tensor([c['amplitude'] for c in classes], device=device)
    t = truth
    carrier = torch.cos(2 * math.pi * freq[t] * (
        xs[None, :] * torch.cos(theta[t]) + ys[:, None] * torch.sin(theta[t]))
        + phase[region])
    img = colour[t] + (amp[t] * carrier)[..., None]
    img += float(mix['noise']) * torch.randn((h, w, 3), generator=gen,
                                             device=device)
    return torch.clamp_(img, 0.0, 1.0), truth.to(torch.int32)


def _blob_volume(mix, gen, device):
    shape = tuple(mix['shape'])
    coarse = tuple(mix['field_grid'])
    field = torch.randn((1, 1) + coarse, generator=gen, device=device)
    field = F.interpolate(field, size=shape, mode='trilinear',
                          align_corners=True)[0, 0]
    truth = field > float(mix['threshold'])
    lo, hi = mix['intensities']
    vol = torch.where(truth, float(hi), float(lo))
    vol += float(mix['noise']) * torch.randn(shape, generator=gen,
                                             device=device)
    return vol, truth.to(torch.int32)


KINDS = {'tissue_tiles': _tissue_tile, 'blob_volumes': _blob_volume}


def make_item(mix, seed, index, device):
    """(item, truth) tensors on ``device``: item ``index`` of the mix's pool
    for run seed ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(item_seed(seed, index))
    return KINDS[mix['kind']](mix, gen, torch.device(device))


def make_pool(mix, seed, device):
    """The mix's pool of ``pool`` distinct host (numpy) items."""
    return [make_item(mix, seed, i, device)[0].cpu().numpy()
            for i in range(int(mix['pool']))]


def picture_elements(mix):
    """Pixels or voxels of one item."""
    return int(np.prod(mix['shape']))
