"""Supervoxel adjacency with a static (padded) edge list, and 'model' edge
weights (frozen from the port's ``ops/graph``).

The edge list holds the ``8 * K`` smallest distinct codes ``lo * K + hi``
of neighbouring voxel pairs.  :func:`adjacency_edges_3d` gets it from the
grid invariant of SLIC supervoxels: two adjacent voxels carry labels whose cells lie at
most 3 apart in every axis, so a (K, 7**3) presence table, filled from the
three axis-neighbour compares, holds exactly the set of distinct pairs, and
one sort of its present codes gives the reference's first ``8 * K`` of
them.
"""

import torch


#: the 343 cell offsets (dz, dy, dx) in [-3, 3]^3 of the presence table
NEAR_OFFSETS3 = [(a, b, c) for a in range(-3, 4) for b in range(-3, 4)
                 for c in range(-3, 4)]


def edge_capacity(num_segments):
    """Static padded edge count of the reference (``8 * K``)."""
    return 8 * num_segments


def _padded_edges(uniq, k):
    """Sorted distinct codes ``lo * k + hi`` (the sentinel ``k * k`` among
    them or not) -> (edges (8k, 2) int32, valid (8k,) bool)."""
    sentinel = k * k
    e_max = edge_capacity(k)
    uniq = uniq[:e_max]
    if uniq.numel() < e_max:
        uniq = torch.cat([uniq, uniq.new_full((e_max - uniq.numel(),),
                                              sentinel)])
    valid = uniq < sentinel
    uniq = torch.where(valid, uniq, 0)
    edges = torch.stack([torch.div(uniq, k, rounding_mode='floor'),
                         uniq % k], dim=-1)
    return edges.to(torch.int32), valid


def _cell3d(labels, gy, gx):
    z = torch.div(labels, gy * gx, rounding_mode='floor')
    r = labels - z * (gy * gx)
    y = torch.div(r, gx, rounding_mode='floor')
    return z, y, r - y * gx


def grid3d_adjacency_presence(labels, cfg):
    """(K, 343) bool: entry [lo, j] is set when two conn6-adjacent voxels
    carry labels lo < hi with cell(hi) - cell(lo) = NEAR_OFFSETS3[j].

    :param labels: (Z, H, W) integer supervoxel labels in [0, K) on the
        grid of ``cfg`` (a ``Slic3DConfig``), as ``slic3d_segment`` gives
        them; a pair of cells further apart than 3 in an axis is not
        representable and is left out (SLIC labels have none)
    """
    _, gy, gx = cfg.grid
    k = cfg.n_segments
    pres = torch.zeros(k * 343 + 1, dtype=torch.bool, device=labels.device)
    for axis in range(3):
        n = labels.shape[axis]
        if n < 2:
            continue
        a = labels.narrow(axis, 0, n - 1)
        b = labels.narrow(axis, 1, n - 1)
        lo = torch.minimum(a, b).to(torch.int64)
        hi = torch.maximum(a, b).to(torch.int64)
        lz, ly, lx = _cell3d(lo, gy, gx)
        hz, hy, hx = _cell3d(hi, gy, gx)
        dz, dy, dx = hz - lz, hy - ly, hx - lx
        keep = ((lo != hi) & (dz.abs() <= 3) & (dy.abs() <= 3)
                & (dx.abs() <= 3))
        code = lo * 343 + ((dz + 3) * 7 + (dy + 3)) * 7 + (dx + 3)
        pres[torch.where(keep, code, k * 343).reshape(-1)] = True
    return pres[:k * 343].reshape(k, 343)


def adjacency_edges_3d(labels, num_segments, cfg):
    """conn6 adjacency of SLIC supervoxels on the grid of ``cfg`` (a
    ``Slic3DConfig``), from the presence table of
    :func:`grid3d_adjacency_presence`.

    :returns: (edges (8K, 2) int32 pairs lo < hi in ascending ``lo*K + hi``
        order, valid (8K,) bool); invalid slots hold (0, 0).  Beyond 8K
        distinct pairs the smallest codes are kept, as the reference's
        ``jnp.unique(size=8K)`` does.
    """
    k = num_segments
    gz, gy, gx = cfg.grid
    pres = grid3d_adjacency_presence(labels, cfg)
    dev = pres.device
    off = torch.tensor(NEAR_OFFSETS3, device=dev)
    delta = (off[:, 0] * gy + off[:, 1]) * gx + off[:, 2]
    lo = torch.arange(k, device=dev)[:, None]
    codes = torch.where(pres, lo * (k + 1) + delta, k * k).reshape(-1)
    return _padded_edges(torch.sort(codes).values, k)


def compute_spatial_dist(centers, edges, valid, relative=False):
    """Euclidean distance between adjacent superpixel centres; with
    ``relative=True`` divided by the mean over the valid edges."""
    e = edges.to(torch.int64)
    d = centers[e[:, 0]] - centers[e[:, 1]]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    if relative:
        mean = torch.sum(dist * valid) / torch.clamp_min(torch.sum(valid), 1.0)
        dist = dist / torch.clamp_min(mean, 1e-12)
    return dist


def _masked_std(x, valid):
    n = torch.clamp_min(torch.sum(valid), 1.0)
    m = torch.sum(x * valid) / n
    return torch.sqrt(torch.sum(((x - m) ** 2) * valid) / n)


def _std_scaled_exp(dist, valid):
    std = _masked_std(dist, valid)
    return torch.exp(-dist / torch.clamp_min(2.0 * std ** 2, 1e-12))


def _pair_distance(edges, vectors, metric):
    e = edges.to(torch.int64)
    diff = vectors[e[:, 0]] - vectors[e[:, 1]]
    if metric == 'l1':
        return torch.sum(torch.abs(diff), dim=-1)
    if metric == 'l2':
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    if metric == 'lT':
        return torch.amax(diff * diff, dim=-1)
    raise ValueError('unknown edge metric: %r' % metric)


def edge_model_weights(edges, valid, proba, metric='lT'):
    """Model-driven edge weights ``exp(-dist / (2 * std(dist)**2))``;
    metric in {'l1', 'l2', 'lT'}."""
    return _std_scaled_exp(_pair_distance(edges, proba, metric), valid)
