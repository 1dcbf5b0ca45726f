"""Shape priors for region growing: survival tables of ray lengths and
their batched bilinear lookup (port of ``pyimsegm_tpu.ops.shape_prior``).

An object's shape is a per-angle survival function of its ray lengths; the
prior of a point is that table read bilinearly at the point's angle and
distance from the object's centre.  :func:`shape_prior_points` reads it
for every point, and for every object at once when given (O, A, D) tables,
in one batch of f32 gathers on the points' device.
"""

import math

import numpy as np
import torch


def norm_cdf(x, mean, std):
    """Normal CDF by ``erf``, in the dtype of ``x``."""
    return 0.5 * (1.0 + torch.special.erf((x - mean) / (std * math.sqrt(2.0))))


def compute_cumulative_distrib(means, stds, weights, max_dist,
                               device='cuda'):
    """Survival-function table of a ray-length mixture, per angle: the
    weighted normal CDF mixture over distances 0..max_dist, min-max
    normalised per angle and flipped (+1e-9), in f32, computed on
    ``device``.

    :param means: (J, A) component means per direction
    :param stds: (J, A) component stds per direction
    :param weights: (J,) component weights
    :returns: (A, D+1) f32 numpy array
    """
    means = np.asarray(means, float)
    stds = np.asarray(stds, float)
    weights = np.asarray(weights, float)
    j = len(weights)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    samples = torch.arange(int(max_dist) + 1, dtype=torch.float32,
                           device=device)
    cdf = norm_cdf(samples[None, None, :], f32(means[:j])[:, :, None],
                   f32(stds[:j])[:, :, None])                  # (J, A, D)
    cdf = torch.sum(f32(weights)[:, None, None] * cdf, dim=0)  # (A, D)
    lo = torch.amin(cdf, dim=1, keepdim=True)
    hi = torch.amax(cdf, dim=1, keepdim=True)
    cdf = (cdf - lo) / (hi - lo)
    return (1.0 - cdf + 1e-9).cpu().numpy()


def shape_prior_points(points, cdf_table, centre, angle_shift):
    """Bilinear shape-prior lookup for a batch of points: the angle is
    ``(90 - atan2(dy, dx) - shift) mod 360`` from the centre, the table is
    read bilinearly in (angle, distance) with its first row repeated after
    the last, and a distance beyond the table takes the last column at the
    nearest angle (``round``, half to even).

    :param points: (N, 2) tensor (row, col)
    :param cdf_table: (A, D) survival table, or (O, A, D) for O objects
    :param centre: (2,) or (O, 2)
    :param angle_shift: scalar degrees, or (O,)
    :returns: (N,) f32 priors, or (O, N)
    """
    dev = points.device
    table = torch.as_tensor(cdf_table, dtype=torch.float32, device=dev)
    single = table.ndim == 2
    table = table.reshape((-1,) + tuple(table.shape[-2:]))
    o, a, d = table.shape
    table = torch.cat([table, table[:, :1]], dim=1)           # (O, A+1, D)
    centre = torch.as_tensor(centre, dtype=torch.float32,
                             device=dev).reshape(o, 2)
    shift = torch.as_tensor(angle_shift, dtype=torch.float32,
                            device=dev).reshape(-1)
    angle_step = 360.0 / a

    pts = points.to(torch.float32)
    diff = pts[None, :, :] - centre[:, None, :]               # (O, N, 2)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    angle = torch.rad2deg(torch.atan2(diff[..., 1], diff[..., 0]))
    angle = torch.remainder(2.0 * 360.0 + 90.0 - angle - shift[:, None],
                            360.0)
    angle_norm = angle / angle_step

    a0 = torch.clamp(torch.floor(angle_norm).to(torch.int64), 0, a - 1)
    d0 = torch.floor(dist).to(torch.int64)
    d0c = torch.clamp(d0, 0, d - 2)
    fa = angle_norm - a0
    fd = dist - d0
    flat = table.reshape(-1)
    base = torch.arange(o, device=dev)[:, None] * ((a + 1) * d)

    def at(ai, di):
        return flat[base + ai * d + di]

    v00, v01 = at(a0, d0c), at(a0, d0c + 1)
    v10, v11 = at(a0 + 1, d0c), at(a0 + 1, d0c + 1)
    interp = (v00 * (1 - fa) * (1 - fd) + v10 * fa * (1 - fd)
              + v01 * (1 - fa) * fd + v11 * fa * fd)
    a_round = torch.clamp(torch.round(angle_norm).to(torch.int64), 0, a)
    far = at(a_round, torch.full_like(a_round, d - 1))
    out = torch.where(dist >= (d - 1), far, interp)
    return out[0] if single else out


def compute_shape_prior_table_cdf(point, cum_distribution, centre,
                                  angle_shift=0, device='cpu'):
    """The prior of one point (a python float)."""
    out = shape_prior_points(
        torch.tensor([list(point)], dtype=torch.float32, device=device),
        np.asarray(cum_distribution, np.float32),
        np.asarray(centre, np.float32), float(angle_shift))
    return float(out[0])
