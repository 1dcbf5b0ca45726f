"""Segment reductions, lookup and the dense MRF on the SLIC seed grid.

Port of the main-path part of ``pyimsegm_tpu.ops.grid``.  Every SLIC
label is one of the 3x3 seeds around its pixel's tile, so per-superpixel
sums are masked tile sums routed by 9 grid shifts, and superpixel adjacency
fits a dense (gh, gw, 25) tensor of relative seed offsets in [-2, 2]^2.

The pixel-scale lookup and adjacency run through ``ops/grid_cuda.py``
(CUDA kernel for a CUDA tensor, plain twin for a CPU tensor).
:func:`grid_segment_sum` is plain PyTorch and serves the CPU path; its
kernel (``grid_reduce``) is not ported yet, so it refuses CUDA tensors.
"""

import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.ops import grid_cuda
from pyimsegm_tpu_torch.ops.slic import SlicConfig

_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _pad_to_grid(arr, cfg: SlicConfig, fill=0):
    """Pad the first two axes of ``arr`` to (pad_h, pad_w) with ``fill``."""
    ph = cfg.pad_h - arr.shape[0]
    pw = cfg.pad_w - arr.shape[1]
    if ph == 0 and pw == 0:
        return arr
    out = torch.full((cfg.pad_h, cfg.pad_w) + tuple(arr.shape[2:]), fill,
                     dtype=arr.dtype, device=arr.device)
    out[:arr.shape[0], :arr.shape[1]] = arr
    return out


def _shift2d(grid2d, di, dj):
    """Shift a (gh, gw, ...) grid so cell (y, x) moves to (y+di, x+dj),
    zero-filling."""
    gh, gw = grid2d.shape[:2]
    out = torch.zeros_like(grid2d)
    if abs(di) >= gh or abs(dj) >= gw:
        return out
    out[max(di, 0):gh + min(di, 0), max(dj, 0):gw + min(dj, 0)] = \
        grid2d[max(-di, 0):gh + min(-di, 0), max(-dj, 0):gw + min(-dj, 0)]
    return out


def grid_segment_sum(data, labels, cfg: SlicConfig):
    """Per-superpixel sums of (H, W, F) ``data`` over grid-structured labels:
    per-offset masked tile sums routed to their seeds by 9 grid shifts.

    :returns: (K, F) f32 sums
    """
    if data.is_cuda:
        raise NotImplementedError(
            'grid_segment_sum on CUDA needs the grid_reduce kernel, which '
            'comes with the fitting slice of ROADMAP.md')
    f = data.shape[-1]
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    data_p = _pad_to_grid(data.to(torch.float32), cfg)
    code = grid_cuda._window_code(_pad_to_grid(labels, cfg, fill=-2), cfg)
    out = torch.zeros((gh, gw, f), dtype=torch.float32, device=data.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        w = (code == idx).to(torch.float32)[..., None]
        part = (data_p * w).reshape(gh, step, gw, step, f).sum(dim=(1, 3))
        out = out + _shift2d(part, di, dj)
    return out.reshape(gh * gw, f)


def grid_lookup(table, labels, cfg: SlicConfig):
    """Per-pixel ``table[labels]`` for grid-structured labels.

    The table goes through f32 (integer tables such as graph labels come
    back exactly); pixels whose label lies outside their 3x3 seed window get
    0.

    :param table: (K,) or (K, C) tensor
    :param labels: (H, W) int32
    :returns: (H, W) or (H, W, C) tensor of ``table.dtype``
    """
    squeeze = table.ndim == 1
    if squeeze:
        table = table[:, None]
    out = grid_cuda.grid_lookup(table.to(torch.float32), labels, cfg)
    out = out.to(table.dtype)
    return out[..., 0] if squeeze else out


# ------------------------------------------------------ dense grid graph ---
#
# Channel d of a (gh, gw, 25) tensor is the edge to the seed at relative
# grid offset GRAPH_OFFSETS[d] = (dy, dx) in [-2, 2]^2.

GRAPH_OFFSETS = [(dy, dx) for dy in (-2, -1, 0, 1, 2)
                 for dx in (-2, -1, 0, 1, 2)]
_SELF = GRAPH_OFFSETS.index((0, 0))


def _flip_channel_perm():
    return [GRAPH_OFFSETS.index((-dy, -dx)) for dy, dx in GRAPH_OFFSETS]


def grid_adjacency(labels, cfg: SlicConfig):
    """(gh, gw, 25) 0/1 f32 adjacency between each superpixel and its grid
    neighbours, from conn4 pixel pairs."""
    gh, gw = cfg.grid_h, cfg.grid_w
    words = grid_cuda.grid_adjacency_presence(labels, cfg)      # (gh, gw, 9)
    ch = torch.arange(25, device=words.device, dtype=torch.int32)
    bits = ((words[..., None] >> ch) & 1).to(torch.float32)     # (.., 9, 25)
    adj = torch.zeros((gh, gw, 25), dtype=torch.float32, device=words.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        adj = adj + _shift2d(bits[:, :, idx], di, dj)
    return _sym_mask_adjacency(adj, gh, gw)


def _sym_mask_adjacency(adj, gh, gw):
    """Raw pair channels -> symmetric 0/1 adjacency with out-of-range and
    self channels zeroed."""
    adj = (adj > 0).to(torch.float32)
    perm = _flip_channel_perm()
    partner = torch.stack(
        [_shift2d(adj[..., perm[ci]], -dy, -dx)
         for ci, (dy, dx) in enumerate(GRAPH_OFFSETS)], dim=-1)
    adj = torch.maximum(adj, partner)
    oy = torch.arange(gh, device=adj.device)[:, None]
    ox = torch.arange(gw, device=adj.device)[None, :]
    keep = torch.stack(
        [(oy + dy >= 0) & (oy + dy < gh) & (ox + dx >= 0) & (ox + dx < gw)
         & (ci != _SELF) for ci, (dy, dx) in enumerate(GRAPH_OFFSETS)],
        dim=-1)
    return torch.where(keep, adj, 0.0)


def _neighbor_stack(table_grid):
    """(gh, gw, 25, F): value of the offset-d neighbour for every channel d."""
    return torch.stack(
        [_shift2d(table_grid, -dy, -dx) for dy, dx in GRAPH_OFFSETS], dim=2)


def grid_edge_weights(labels, cfg: SlicConfig, proba=None, features=None,
                      mean_color=None, edge_type='model', adj=None,
                      centers=None):
    """Dense edge weights on the (gh, gw, 25) adjacency, with the numerics
    of the reference's edge-list weights.

    :returns: (gh, gw, 25) weights; 0 where there is no edge
    """
    from pyimsegm_tpu_torch.ops.graphcut import MIN_MAX_EDGE_WEIGHT
    gh, gw = cfg.grid_h, cfg.grid_w
    if adj is None:
        adj = grid_adjacency(labels, cfg)
    n_edges_x2 = torch.clamp_min(torch.sum(adj), 1.0)

    def _std_scaled_exp(dist):
        # each undirected edge is counted twice, identically
        mean = torch.sum(dist * adj) / n_edges_x2
        var = torch.sum(((dist - mean) ** 2) * adj) / n_edges_x2
        std = torch.sqrt(var)
        return torch.exp(-dist / torch.clamp_min(2.0 * std ** 2, 1e-12))

    if edge_type.startswith('model'):
        metric = edge_type.split('_')[-1] if '_' in edge_type else 'lT'
        pg = proba.reshape(gh, gw, -1)
        diff = pg[:, :, None, :] - _neighbor_stack(pg)
        if metric == 'l1':
            dist = torch.sum(torch.abs(diff), dim=-1)
        elif metric == 'l2':
            dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
        else:
            dist = torch.amax(diff * diff, dim=-1)
        weights = _std_scaled_exp(dist)
    elif edge_type == 'features':
        mu = torch.mean(features, dim=0)
        sd = torch.clamp_min(torch.std(features, dim=0, correction=0), 1e-12)
        fg = ((features - mu) / sd).reshape(gh, gw, -1)
        diff = fg[:, :, None, :] - _neighbor_stack(fg)
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
        weights = _std_scaled_exp(dist)
    elif edge_type == 'color':
        cg = mean_color.reshape(gh, gw, -1)
        diff = cg[:, :, None, :] - _neighbor_stack(cg)
        dist = torch.sum(torch.abs(diff), dim=-1)
        weights = _std_scaled_exp(dist)
    else:
        weights = torch.ones((gh, gw, 25), dtype=torch.float32,
                             device=adj.device)

    if edge_type in ('model', 'model_l1', 'model_l2', 'model_lT',
                     'features', 'color', 'spatial'):
        if centers is None:
            h, w = labels.shape
            py, px = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=labels.device),
                torch.arange(w, dtype=torch.float32, device=labels.device),
                indexing='ij')
            coords = torch.stack([py, px, torch.ones_like(py)], dim=-1)
            sums = grid_segment_sum(coords, labels, cfg)
            centers = sums[:, :2] / torch.clamp_min(sums[:, 2:], 1.0)
        cgrid = centers.reshape(gh, gw, 2)
        cdiff = cgrid[:, :, None, :] - _neighbor_stack(cgrid)
        sdist = torch.sqrt(torch.sum(cdiff * cdiff, dim=-1))
        mean_sd = torch.sum(sdist * adj) / n_edges_x2
        rel = sdist / torch.clamp_min(mean_sd, 1e-12)
        weights = weights / torch.clamp_min(rel, 1e-12)

    weights = torch.clamp(weights, 1.0 / MIN_MAX_EDGE_WEIGHT,
                          MIN_MAX_EDGE_WEIGHT)
    return weights * adj


def grid_mrf_energy(label_grid, unary_grid, wgrid, pairwise):
    """E(l) = sum unary + 1/2 sum_(k, d) w * P(l_k, l_nb) (each edge twice)."""
    c = unary_grid.shape[-1]
    u = torch.sum(torch.take_along_dim(unary_grid,
                                       label_grid[..., None].long(), -1))
    onehot = F.one_hot(label_grid.long(), c).to(torch.float32)
    nb = _neighbor_stack(onehot)                            # (gh, gw, 25, C)
    pl = onehot @ pairwise                                  # (gh, gw, C)
    pair = torch.einsum('yxdc,yxc->yxd', nb, pl)
    return u + 0.5 * torch.sum(wgrid * pair)


def solve_mrf_grid(unary, wgrid, pairwise, cfg: SlicConfig, n_mf_iters=30,
                   n_icm_iters=12, damping=0.5):
    """Damped mean-field, then synchronous ICM keeping the best-energy
    labelling, on the 25-neighbour grid graph.  Runs on the device of
    ``unary`` with no host synchronisation.

    :param unary: (K, C)
    :param wgrid: (gh, gw, 25)
    :param pairwise: (C, C)
    :returns: (K,) int32 labels
    """
    gh, gw = cfg.grid_h, cfg.grid_w
    c = unary.shape[-1]
    ug = unary.reshape(gh, gw, c).to(torch.float32)
    pairwise = torch.as_tensor(pairwise, dtype=torch.float32,
                               device=ug.device)

    def message(q):
        nb = _neighbor_stack(q @ pairwise.T)                # (gh, gw, 25, C)
        return torch.einsum('yxd,yxdc->yxc', wgrid, nb)

    q = torch.softmax(-ug, dim=-1)
    for _ in range(n_mf_iters):
        q_new = torch.softmax(-(ug + message(q)), dim=-1)
        q = damping * q_new + (1.0 - damping) * q
    labels = torch.argmin(ug + message(q), dim=-1)

    best_labels = labels
    best_e = grid_mrf_energy(labels, ug, wgrid, pairwise)
    for _ in range(n_icm_iters):
        onehot = F.one_hot(labels, c).to(torch.float32)
        labels = torch.argmin(ug + message(onehot), dim=-1)
        e = grid_mrf_energy(labels, ug, wgrid, pairwise)
        improved = e < best_e
        best_labels = torch.where(improved, labels, best_labels)
        best_e = torch.where(improved, e, best_e)
    return best_labels.reshape(-1).to(torch.int32)
