"""Binary morphology with disk elements, and disk sums of planes (port of
``pyimsegm_tpu.ops.morphology``).

Dilation by a disk is a max over its rows: for each row offset a
horizontal max window of the row's half-width (``F.max_pool2d``), shifted
by the offset with zeros coming in, so samples outside the image count as
0 in a dilation and as 1 in an erosion.  :func:`disk_count_maps` sums each
plane over a disk as a union of horizontal chords read from a padded row
cumsum, over any leading axes.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.utils.device import as_tensor


def disk(radius):
    """Boolean disk footprint: points with L2 distance <= radius."""
    r = int(radius)
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r)


def _row_widths(radius):
    """(row offset, half-width) of each row of the disk footprint."""
    r = int(radius)
    rows = []
    for dy in range(-r, r + 1):
        w = int(np.floor(np.sqrt(max(r * r - dy * dy, 0))))
        rows.append((dy, w))
    return rows


def _shift_rows(x, dy):
    """out[i] = x[i - dy], zeros where i - dy is outside the image."""
    if dy == 0:
        return x
    out = torch.zeros_like(x)
    if dy > 0:
        out[dy:] = x[:-dy]
    else:
        out[:dy] = x[-dy:]
    return out


def binary_dilation(mask, radius, device='cuda'):
    """Dilate a boolean (H, W) mask by a disk; a tensor runs on its device,
    anything else on ``device``."""
    m = as_tensor(mask, device).to(torch.float32)
    out = torch.zeros_like(m)
    for dy, w in _row_widths(radius):
        row_max = F.max_pool2d(m[None, None], (1, 2 * w + 1), stride=1,
                               padding=(0, w))[0, 0]
        out = torch.maximum(out, _shift_rows(row_max, dy))
    return out > 0


def binary_erosion(mask, radius, device='cuda'):
    return ~binary_dilation(~as_tensor(mask, device).to(torch.bool), radius)


def binary_opening(mask, radius, device='cuda'):
    """opening = dilation(erosion(x))."""
    return binary_dilation(binary_erosion(mask, radius, device), radius)


def binary_closing(mask, radius, device='cuda'):
    return binary_erosion(binary_dilation(mask, radius, device), radius)


def disk_count_maps(planes, radius):
    """For every pixel of every plane: the sum within a disk of ``radius``,
    the disk clipped at the image border.  A chord of half-width w centred
    at column x is ``cs[x + w] - cs[x - w - 1]`` of the row cumsum (zeros
    padded left, row totals right); the +dy and -dy rows share a chord, so
    the loop runs ``radius + 1`` steps of three kernels.  Sums of integer
    planes below 2**24 are exact in any order; other planes are added in
    another order than the reference's (within rtol 1e-5).

    :param planes: (..., H, W) float tensor, any leading axes
    :returns: (..., H, W) float sums
    """
    h, w = planes.shape[-2:]
    r = int(radius)
    lead = planes.shape[:-1]
    cs = torch.cumsum(planes, dim=-1)
    cs_pad = torch.cat([planes.new_zeros(lead + (r + 1,)), cs,
                        cs[..., -1:].expand(lead + (r,))], dim=-1)
    out = torch.zeros_like(planes)
    for dy, width in _row_widths(radius):
        if dy < 0:
            continue
        chord = (cs_pad[..., r + 1 + width:r + 1 + width + w]
                 - cs_pad[..., r - width:r - width + w])
        if dy == 0:
            out += chord
        elif dy < h:
            out[..., :h - dy, :] += chord[..., dy:, :]
            out[..., dy:, :] += chord[..., :h - dy, :]
    return out


def disk_count_map(plane, radius):
    """Single-plane :func:`disk_count_maps`."""
    return disk_count_maps(plane, radius)
