"""Superpixel adjacency with a static (padded) edge list, and edge weights
(port of ``pyimsegm_tpu.ops.graph``).

The JAX package hashes every neighbouring pixel pair ``lo * K + hi`` and
keeps the ``8 * K`` smallest distinct codes (``jnp.unique(..., size=8K)``).
:func:`adjacency_edges_2d` does the same for any 2D label map, and
:func:`adjacency_edges_3d` for any 3D one.  Given the grid of SLIC
supervoxels, :func:`adjacency_edges_3d` gets the same edge list from their
grid invariant instead: two adjacent voxels carry labels whose cells lie at
most 3 apart in every axis, so a (K, 7**3) presence table, filled from the
three axis-neighbour compares, holds exactly the set of distinct pairs, and
one sort of its present codes gives the reference's first ``8 * K`` of
them.
"""

import torch

from pyimsegm_tpu_torch.ops import segment_stats

#: the 343 cell offsets (dz, dy, dx) in [-3, 3]^3 of the presence table
NEAR_OFFSETS3 = [(a, b, c) for a in range(-3, 4) for b in range(-3, 4)
                 for c in range(-3, 4)]


def edge_capacity(num_segments):
    """Static padded edge count of the reference (``8 * K``)."""
    return 8 * num_segments


def adjacency_edges_2d(labels, num_segments):
    """conn4 region adjacency of a 2D label map.

    :param labels: (H, W) integer tensor in [0, num_segments)
    :returns: (edges (8K, 2) int32 pairs lo < hi in ascending ``lo*K + hi``
        order, valid (8K,) bool); invalid slots hold (0, 0)
    """
    a = torch.cat([labels[:, :-1].reshape(-1), labels[:-1, :].reshape(-1)])
    b = torch.cat([labels[:, 1:].reshape(-1), labels[1:, :].reshape(-1)])
    return _unique_edges(a, b, num_segments)


def _unique_edges(a, b, num_segments):
    """The ``8 * K`` smallest distinct pair codes of (a, b), padded with
    the sentinel ``K * K`` (which same-label pairs map to)."""
    lo = torch.minimum(a, b).to(torch.int64)
    hi = torch.maximum(a, b).to(torch.int64)
    k = num_segments
    sentinel = k * k
    codes = torch.where(lo == hi, sentinel, lo * k + hi)
    return _padded_edges(torch.unique(codes), k)


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


def adjacency_edges_3d(labels, num_segments, cfg=None):
    """conn6 supervoxel adjacency from a 3D label volume.

    Any label volume takes the reference's hashing of every neighbouring
    voxel pair; SLIC supervoxels on the grid of ``cfg`` (a
    ``Slic3DConfig``) take the presence table of
    :func:`grid3d_adjacency_presence` instead, with the same result.

    :returns: (edges (8K, 2) int32 pairs lo < hi in ascending ``lo*K + hi``
        order, valid (8K,) bool); invalid slots hold (0, 0).  Beyond 8K
        distinct pairs the smallest codes are kept, as the reference's
        ``jnp.unique(size=8K)`` does.
    """
    k = num_segments
    if cfg is None:
        a = torch.cat([labels[:, :, :-1].reshape(-1),
                       labels[:, :-1, :].reshape(-1),
                       labels[:-1, :, :].reshape(-1)])
        b = torch.cat([labels[:, :, 1:].reshape(-1),
                       labels[:, 1:, :].reshape(-1),
                       labels[1:, :, :].reshape(-1)])
        return _unique_edges(a, b, k)
    gz, gy, gx = cfg.grid
    pres = grid3d_adjacency_presence(labels, cfg)
    dev = pres.device
    off = torch.tensor(NEAR_OFFSETS3, device=dev)
    delta = (off[:, 0] * gy + off[:, 1]) * gx + off[:, 2]
    lo = torch.arange(k, device=dev)[:, None]
    codes = torch.where(pres, lo * (k + 1) + delta, k * k).reshape(-1)
    return _padded_edges(torch.sort(codes).values, k)


def adjacency3d_counts(labels, cfg):
    """What the reference's static edge list does to these labels: the
    number of distinct adjacent pairs against the 8K capacity, and how many
    of them have cells 3 apart in some axis (those alias or fall out of
    the 125-channel MRF weights).  Python ints (a host synchronisation)."""
    pres = grid3d_adjacency_presence(labels, cfg)
    off = torch.tensor(NEAR_OFFSETS3, device=pres.device)
    far = (off.abs() == 3).any(dim=1)
    return {'edges': int(pres.sum()), 'capacity': edge_capacity(
        cfg.n_segments), 'far_edges': int(pres[:, far].sum())}


def superpixel_centers(labels, num_segments, ndim=2):
    """Mean voxel coordinate per superpixel (``index_add_``); empty
    segments get 0."""
    coords = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=labels.device)
          for n in labels.shape[:ndim]], indexing='ij')
    data = torch.stack([c.reshape(-1) for c in coords], dim=-1)
    ones = torch.ones((data.shape[0], 1), dtype=torch.float32,
                      device=labels.device)
    sums = segment_stats._segment_sum(torch.cat([data, ones], dim=-1),
                                      labels.reshape(-1), num_segments)
    return sums[:, :ndim] / torch.clamp_min(sums[:, ndim:], 1.0)


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


def edge_vector_weights(edges, valid, vectors, metric):
    """'color' (``metric='l1'``, manhattan) / 'features' (euclidean) edge
    weights with the same scaling."""
    return _std_scaled_exp(
        _pair_distance(edges, vectors, 'l1' if metric == 'l1' else 'l2'),
        valid)
