"""Ray features: the distance from a point to an object boundary at each
angle (port of ``pyimsegm_tpu.ops.ray``).

All (position, angle) rays march together, a chunk of ``_RAY_CHUNK``
nearest-pixel samples at a time, and the first boundary hit of each ray is
an argmax over the chunk's steps.  The stepping is the reference's: the
direction ``(sin a, cos a) / max(|sin a|, |cos a|)`` (one pixel along the
dominant axis a step), samples at ``round(pos + grad * t)`` (half to
even), the euclidean distance to the hit, -1 where the ray leaves the
image first.  The march runs a fixed ``ceil(diagonal / _RAY_CHUNK)``
chunks, with no host synchronisation: a ray's first hit does not change in
the chunks after it, so this is the reference's early-exit loop's result.

Also the FFT phase alignment of rays (numpy, and batched in torch), and
the host helpers that interpolate, back-project and thin ray points.
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.utils.device import as_tensor


def _ray_directions(angle_step, device=None):
    angles = np.arange(0, 360, angle_step)
    rad = np.deg2rad(angles)
    grad = np.stack([np.sin(rad), np.cos(rad)], axis=1)
    grad = grad / np.abs(grad).max(axis=1, keepdims=True)
    return angles, torch.as_tensor(grad.astype(np.float32), device=device)


#: ladder steps a chunk of the march
_RAY_CHUNK = 128


def ray_features_positions_core(seg_binary, positions, angle_step=5.0,
                                edge='up'):
    """Ray distances for many positions at once.

    :param seg_binary: (H, W) bool / float boundary mask tensor
    :param positions: (P, 2) float (row, col) tensor on the same device
    :param edge: 'up' (first entry into the mask) or 'down' (first exit
        after an entry)
    :returns: (P, A) f32 distances; -1 where the ray leaves the image first,
        all zeros at a position inside the mask for 'up'
    """
    seg = seg_binary.to(torch.bool)
    dev = seg.device
    h, w = seg.shape
    n_steps = int(np.ceil(np.sqrt(h * h + w * w)))
    _angles, grad = _ray_directions(angle_step, dev)       # (A, 2)
    a = grad.shape[0]
    pos = positions.to(torch.float32)                       # (P, 2)
    p = pos.shape[0]

    origin = seg[pos[:, 0].to(torch.int64).clamp(0, h - 1),
                 pos[:, 1].to(torch.int64).clamp(0, w - 1)]  # (P,)
    org = origin[:, None].expand(p, a)
    tc = torch.arange(1, _RAY_CHUNK + 1, dtype=torch.float32, device=dev)

    first = torch.full((p, a), -1, dtype=torch.int64, device=dev)
    alive = torch.ones((p, a), dtype=torch.bool, device=dev)
    prev = org
    for t0 in range(0, n_steps, _RAY_CHUNK):
        t = t0 + tc                                         # (C,)
        cy = pos[:, None, None, 0] + grad[None, :, None, 0] * t
        cx = pos[:, None, None, 1] + grad[None, :, None, 1] * t
        ry = torch.round(cy)
        rx = torch.round(cx)
        inb = (cy >= 0) & (ry < h) & (cx >= 0) & (rx < w)
        samples = seg[ry.to(torch.int64).clamp(0, h - 1),
                      rx.to(torch.int64).clamp(0, w - 1)]   # (P, A, C)
        # in-bounds is monotone along the ray; fold in the carried state
        alive_c = (torch.cummin(inb.to(torch.uint8), dim=-1).values
                   .to(torch.bool) & alive[..., None])
        if edge == 'up':
            hit = samples & alive_c
        else:
            prev_c = torch.cat([prev[..., None], samples[..., :-1]], dim=-1)
            hit = prev_c & ~samples & alive_c
        has = hit.any(dim=-1)
        loc = t0 + 1 + torch.argmax(hit.to(torch.uint8), dim=-1)
        first = torch.where((first < 0) & has, loc, first)
        prev = torch.where(alive_c[..., -1], samples[..., -1], prev)
        alive = alive_c[..., -1]

    # a hit found beyond the diagonal cap is out of the reference's march
    any_hit = (first > 0) & (first <= n_steps)
    step_len = torch.sqrt(torch.sum(grad * grad, dim=-1))  # (A,)
    dist = first.to(torch.float32) * step_len[None, :]
    dist = torch.where(any_hit, dist, torch.full_like(dist, -1.0))
    if edge == 'up':
        dist = torch.where(org, torch.zeros_like(dist), dist)
    return dist


def compute_ray_features_segm_2d(seg_binary, position, angle_step=5.0,
                                 smooth_coef=0, edge='up', device='cuda'):
    """Ray distances from one position (numpy, (A,))."""
    seg = as_tensor(seg_binary, device)
    dist = ray_features_positions_core(
        seg, torch.tensor([list(position)], dtype=torch.float32,
                          device=seg.device),
        angle_step=float(angle_step), edge=edge)[0].cpu().numpy()
    if smooth_coef is not None and smooth_coef > 0:
        from scipy.ndimage import gaussian_filter1d
        dist = gaussian_filter1d(dist, smooth_coef)
    return dist


def shift_ray_features(ray_dist, method='phase'):
    """Rotation alignment by the FFT phase of the dominant harmonic (or by
    the plain maximum); returns (shifted rays, shift in degrees)."""
    ray_dist = np.asarray(ray_dist)
    angle_step = 360.0 / len(ray_dist)
    if method == 'phase':
        ext = np.hstack([ray_dist] * 5)
        spectrum = np.fft.fft(ext - np.mean(ext)) / float(len(ext))
        magnitude = np.abs(spectrum)[:len(ext) // 2]
        idx = int(np.argmax(magnitude))
        shift = np.rad2deg(-np.angle(spectrum)[idx])
        shift = (360 + shift) if shift < 0 else shift
    else:
        shift = float(np.argmax(ray_dist) * angle_step)
    k = int(round(shift / angle_step))
    return np.concatenate([ray_dist[k:], ray_dist[:k]]), shift


def shift_ray_features_batched(rays):
    """Batched FFT phase alignment (:func:`shift_ray_features` for all
    rows at once, in f32 / complex64 on the rays' device).

    :param rays: (P, A) distances tensor
    :returns: (aligned (P, A), shifts (P,) degrees)
    """
    rays = rays.to(torch.float32)
    p, a = rays.shape
    ext = rays.repeat(1, 5)
    spec = torch.fft.fft(ext - torch.mean(ext, dim=1, keepdim=True),
                         dim=1) / (5.0 * a)
    mag = torch.abs(spec)[:, :5 * a // 2]
    idx = torch.argmax(mag, dim=1)
    ang = -torch.angle(spec[torch.arange(p, device=rays.device), idx])
    shift = torch.rad2deg(ang)
    shift = torch.where(shift < 0, shift + 360.0, shift)
    k = torch.round(shift / (360.0 / a)).to(torch.int64) % a
    col = (torch.arange(a, device=rays.device)[None, :] + k[:, None]) % a
    return torch.gather(rays, 1, col), shift


def compute_ray_features_positions(segm, list_positions, angle_step=5.0,
                                   border_labels=None, segm_open=None,
                                   smooth_ray=None, shifting=True, edge='up',
                                   device='cuda'):
    """Ray features for many positions, each row aligned by
    :func:`shift_ray_features` on the host when ``shifting``.

    :returns: (rays (P, A) numpy, shifts list, names)
    """
    from pyimsegm_tpu_torch.ops.morphology import binary_opening
    segm = np.asarray(segm)
    border_labels = border_labels if border_labels is not None else [0]
    if segm.ndim == 3:
        segm = np.argmax(segm, axis=-1)
    seg_binary = as_tensor(np.isin(segm, border_labels), device)
    if isinstance(segm_open, int):
        seg_binary = binary_opening(seg_binary, segm_open)
    rays = ray_features_positions_core(
        seg_binary, as_tensor(np.asarray(list_positions, np.float32),
                              seg_binary.device),
        angle_step=float(angle_step), edge=edge).cpu().numpy()
    if smooth_ray is not None and smooth_ray > 0:
        from scipy.ndimage import gaussian_filter1d
        rays = gaussian_filter1d(rays, smooth_ray, axis=1)
    shifts = []
    if shifting:
        out = []
        for r in rays:
            r2, s = shift_ray_features(r)
            out.append(r2)
            shifts.append(float(s))
        rays = np.asarray(out)
    else:
        shifts = [0.0] * len(rays)
    names = ['ray-lb_%s-agl_%i' % (''.join(map(str, border_labels)), int(a))
             for a in np.linspace(0, 360 - angle_step, rays.shape[1])]
    return rays, shifts, names


def interpolate_ray_dist(ray_dists, order='spline'):
    """Fill -1 gaps by a polynomial, a periodic spline or a cosine LSQ
    fit (host, scipy)."""
    from scipy import interpolate, optimize
    x_space = np.arange(len(ray_dists))
    ray_dists = np.array(ray_dists)
    missing = ray_dists == -1
    x_train = x_space[~missing]
    y_train = ray_dists[~missing]
    if not y_train.size:
        return ray_dists
    x_ext = np.hstack((x_train - len(x_space), x_train,
                       x_train + len(x_space)))
    y_ext = np.array(y_train.tolist() * 3)
    if isinstance(order, int):
        z = np.polyfit(x_train, y_train, order)
        ray_dists[missing] = np.poly1d(z)(x_space[missing])
    elif order == 'spline':
        spline = interpolate.InterpolatedUnivariateSpline(x_ext, y_ext)
        ray_dists[missing] = spline(x_space[missing])
    elif order == 'cos':
        def _fn(xp, t):
            return xp[0] + xp[1] * np.sin(xp[2] + xp[3] * t)

        x0 = np.array([np.mean(y_train),
                       (y_train.max() - y_train.min()) / 2.0,
                       0, len(x_space) / np.pi])
        res = optimize.least_squares(lambda xp, t, y: _fn(xp, t) - y, x0,
                                     gtol=1e-1, args=(x_train, y_train))
        ray_dists[missing] = _fn(res.x, x_space[missing])
    return ray_dists


def reconstruct_ray_features_2d(position, ray_features, shift=0):
    """Back-project ray distances to boundary points (host)."""
    if len(position) != 2:
        raise ValueError('positions has to have 2 coordinates')
    if len(ray_features) <= 2:
        raise ValueError('required at least 2 features')
    ray_features = np.asarray(ray_features, float)
    angles = np.linspace(0, 2 * np.pi, len(ray_features), endpoint=False)
    angles = (np.pi / 2.0) - angles - np.deg2rad(shift)
    mask = (ray_features >= 0) & ~np.isinf(ray_features)
    angles = angles[mask]
    rays = ray_features[mask]
    dx = np.cos(angles) * rays
    dy = np.sin(angles) * rays
    return np.tile(position, (len(rays), 1)) + np.stack([dx, dy], axis=1)


def reduce_close_points(points, dist_thr):
    """Greedy removal of points closer than a threshold (host, scipy)."""
    from scipy import spatial
    points = np.asarray(points)
    if len(points) <= 2:
        raise ValueError('too few point to be reduced')
    dist = spatial.distance.cdist(points, points)
    np.fill_diagonal(dist, np.inf)
    while np.min(dist) < dist_thr and len(points) > 0:
        coord = np.unravel_index(dist.argmin(), dist.shape)
        i = max(coord)
        points = np.delete(points, i, axis=0)
        dist = np.delete(np.delete(dist, i, axis=0), i, axis=1)
    return points

