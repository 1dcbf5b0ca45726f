"""Multi-object morphological active contours (Chan-Vese, ACWE) (port of
``pyimsegm_tpu.ops.snakes``).

All N object level sets evolve together as one (N, H, W) f32 tensor of
0/1 values on the image's device.  The morphological gradient and the
curvature smoothing are 3x3 window reductions: dilation is ``max_pool2d``
(its padding is -inf, as the JAX window's init), erosion the negated
``max_pool2d`` of the negation, and the 3x3 sum ``avg_pool2d`` with a
divisor of 1, exact on 0/1 values.  The loop issues its kernels with no
host synchronisation: the iteration count and the smoothing thresholds
are Python ints.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.utils.device import as_tensor


def _dilate(u):
    return F.max_pool2d(u, 3, 1, 1)


def _erode(u):
    return -F.max_pool2d(-u, 3, 1, 1)


def _curvature_smooth(u, threshold):
    """One binary median-flow step: the 3x3 majority vote (``threshold``
    alternates 5 / 4 to balance shrinking and growing)."""
    s = F.avg_pool2d(u, 3, 1, 1, count_include_pad=True, divisor_override=1)
    return (s >= threshold).to(u.dtype)


def _acwe_evolve(image, u, n_iter, smoothing, lambda1, lambda2):
    objects = torch.arange(u.shape[0], device=u.device)[:, None, None]
    for it in range(n_iter):
        # region statistics: per-object inside mean, shared background mean
        inside_sum = torch.sum(u * image, dim=(1, 2))
        inside_cnt = torch.clamp_min(torch.sum(u, dim=(1, 2)), 1.0)
        c1 = inside_sum / inside_cnt                            # (N,)
        bg = 1.0 - torch.amax(u, dim=0)
        c2 = torch.sum(bg * image) / torch.clamp_min(torch.sum(bg), 1.0)

        # ACWE forcing on the boundary band (morphological gradient > 0)
        grad = _dilate(u) - _erode(u)
        d_in = (image[None] - c1[:, None, None]) ** 2
        d_out = (image[None] - c2) ** 2
        aux = grad * (lambda1 * d_in - lambda2 * d_out)
        u = torch.where(aux < 0, 1.0, torch.where(aux > 0, 0.0, u))

        for s in range(smoothing):
            u = _curvature_smooth(u, 5.0 if (it + s) % 2 == 0 else 4.0)

        # multi-object exclusion: a contested pixel goes to the object whose
        # inside mean matches it best (the first on a tie)
        claims = torch.sum(u, dim=0)
        best = torch.argmin(torch.where(u > 0, d_in, float('inf')), dim=0)
        keep = (claims <= 1) | (best[None] == objects)
        u = u * keep.to(u.dtype)
    return u


def morph_acwe_multi(image, init_masks, n_iter=200, smoothing=1,
                     lambda1=1.0, lambda2=1.0, device='cuda'):
    """Evolve N morphological Chan-Vese level sets jointly.

    :param image: (H, W) float array or tensor
    :param init_masks: (N, H, W) binary initial level sets
    :param n_iter: evolution steps
    :param smoothing: curvature-smoothing passes per step
    :param device: where a numpy input runs (a tensor stays on its own)
    :returns: (H, W) int32 tensor, 0 = background, 1..N = objects (the
        first object on a tie)
    """
    image = as_tensor(image, device).to(torch.float32)
    u0 = as_tensor(init_masks, image.device).to(torch.float32)
    u = _acwe_evolve(image, u0.to(image.device), int(n_iter), int(smoothing),
                     float(lambda1), float(lambda2))
    labels = torch.where(torch.amax(u, dim=0) > 0,
                         torch.argmax(u, dim=0) + 1, 0)
    return labels.to(torch.int32)


def circle_masks(shape, centers, radius=15):
    """(N, H, W) f32 binary disks around the (row, col) centres."""
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((len(centers), h, w), np.float32)
    for i, c in enumerate(centers):
        masks[i] = (((yy - float(c[0])) ** 2 + (xx - float(c[1])) ** 2)
                    <= radius ** 2)
    return masks
