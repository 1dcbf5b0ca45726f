"""Segment reductions, lookup, connectivity enforcement, the min-size merge
and the dense MRF on the SLIC seed grid.

Port of the main-path part of ``pyimsegm_tpu.ops.grid``.  Every SLIC
label is one of the 3x3 seeds around its pixel's tile, so per-superpixel
sums are masked tile sums routed by 9 grid shifts, and superpixel adjacency
fits a dense (gh, gw, 25) tensor of relative seed offsets in [-2, 2]^2.

The pixel-scale passes run through ``ops/grid_cuda.py`` (segment sums,
lookup, the adjacency and the pair counts each with its route to the seeds,
moments with the donor apply),
``ops/enforce_cuda.py`` (anchor seed + reach + absorb) and
``ops/connectivity_cuda.py`` (reach + absorb of wide images): a CUDA
kernel for a CUDA tensor, the plain twin for a CPU tensor.  The (K,)-sized
donor tables are plain PyTorch on the tensor's device, with no host
synchronisation.
"""

import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.ops import grid_cuda
from pyimsegm_tpu_torch.ops.slic import SlicConfig

_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]
_BIG = 2 ** 20


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


def _shift2d(grid2d, di, dj, fill=0):
    """Shift a (gh, gw, ...) grid (or an (H, W, ...) image) so cell (y, x)
    moves to (y+di, x+dj), filling vacated cells with ``fill``."""
    gh, gw = grid2d.shape[:2]
    out = torch.full_like(grid2d, fill)
    if abs(di) >= gh or abs(dj) >= gw:
        return out
    out[max(di, 0):gh + min(di, 0), max(dj, 0):gw + min(dj, 0)] = \
        grid2d[max(-di, 0):gh + min(-di, 0), max(-dj, 0):gw + min(-dj, 0)]
    return out


def grid_segment_sum(data, labels, cfg: SlicConfig):
    """Per-superpixel sums of (H, W, F) ``data`` over grid-structured labels
    (:func:`grid_cuda.grid_reduce`: the kernel for CUDA tensors, the plain
    masked tile sums for CPU tensors).

    :returns: (K, F) f32 sums
    """
    return grid_cuda.grid_reduce(data, labels, cfg)


def grid_geometry_moments(feat, labels, cfg: SlicConfig):
    """Per-superpixel geometry + colour moments in one measurement.

    :param feat: (H, W, F) float feature image
    :param labels: (H, W) int32 grid-structured labels
    :returns: (K, 2F+3) f32 ``[sum feat, sum feat^2, count, sum y, sum x]``
    """
    return grid_cuda.grid_moments_apply(feat, labels, None, cfg)[1]


def grid_lookup(table, labels, cfg: SlicConfig):
    """Per-pixel ``table[labels]`` for grid-structured labels.

    f32 and int32 tables are looked up as they are; any other dtype goes
    through f32 (integer tables come back exactly below 2**24).  Pixels
    whose label lies outside their 3x3 seed window get 0.

    :param table: (K,) or (K, C) tensor
    :param labels: (H, W) int32
    :returns: (H, W) or (H, W, C) tensor of ``table.dtype``
    """
    if table.dtype in (torch.float32, torch.int32):
        return grid_cuda.grid_lookup(table, labels, cfg)
    return grid_cuda.grid_lookup(table.to(torch.float32), labels,
                                 cfg).to(table.dtype)


def grid_segment_count(labels, cfg: SlicConfig):
    """(K,) pixel counts per superpixel."""
    ones = torch.ones(labels.shape + (1,), dtype=torch.float32,
                      device=labels.device)
    return grid_segment_sum(ones, labels, cfg)[:, 0]


def grid_segment_min(value, labels, cfg: SlicConfig):
    """(K,) per-superpixel minimum of an (H, W) float map: nine masked tile
    min-reductions + nine grid shifts; empty superpixels get +inf."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    value_p = _pad_to_grid(value.to(torch.float32), cfg, fill=float('inf'))
    code = grid_cuda._window_code(_pad_to_grid(labels, cfg, fill=-2), cfg)
    out = torch.full((gh, gw), float('inf'), dtype=torch.float32,
                     device=value.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        part = torch.where(code == idx, value_p, float('inf')) \
            .reshape(gh, step, gw, step).amin(dim=(1, 3))
        out = torch.minimum(out, _shift2d(part, di, dj, float('inf')))
    return out.reshape(gh * gw)


# ------------------------------------------------------ dense grid graph ---
#
# Channel d of a (gh, gw, 25) tensor is the edge to the seed at relative
# grid offset GRAPH_OFFSETS[d] = (dy, dx) in [-2, 2]^2.

GRAPH_OFFSETS = [(dy, dx) for dy in (-2, -1, 0, 1, 2)
                 for dx in (-2, -1, 0, 1, 2)]
_SELF = GRAPH_OFFSETS.index((0, 0))


def _flip_channel_perm():
    return [GRAPH_OFFSETS.index((-dy, -dx)) for dy, dx in GRAPH_OFFSETS]


def _sym_mask_adjacency(adj, gh, gw):
    """Symmetrise raw (gh, gw, 25) pair-count channels into a 0/1 f32
    adjacency (edge (a, d) implies (a + d, -d)) and zero the channels that
    leave the grid and the self channel (the last step of the row-sharded
    adjacency, ``parallel/tiled.py``)."""
    adj = (adj > 0).to(torch.float32)
    perm = _flip_channel_perm()
    partner = torch.stack(
        [_shift2d(adj[..., perm[ci]], -dy, -dx)
         for ci, (dy, dx) in enumerate(GRAPH_OFFSETS)], dim=-1)
    adj = torch.maximum(adj, partner)
    oy = torch.arange(gh, device=adj.device)[:, None, None]
    ox = torch.arange(gw, device=adj.device)[None, :, None]
    dy = torch.tensor([d[0] for d in GRAPH_OFFSETS], device=adj.device)
    dx = torch.tensor([d[1] for d in GRAPH_OFFSETS], device=adj.device)
    ok = ((oy + dy >= 0) & (oy + dy < gh) & (ox + dx >= 0) & (ox + dx < gw)
          & (torch.arange(25, device=adj.device) != _SELF))
    return torch.where(ok, adj, 0.0)


def grid_adjacency(labels, cfg: SlicConfig):
    """(gh, gw, 25) 0/1 f32 adjacency between each superpixel and its grid
    neighbours, from conn4 pixel pairs (:func:`grid_cuda.grid_adjacency`:
    the pass and its route in one C call for CUDA tensors, the plain chain
    for CPU tensors)."""
    return grid_cuda.grid_adjacency(labels, cfg)


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


def wgrid_from_edges(edges, valid, weights, cfg: SlicConfig):
    """(gh, gw, 25) symmetric edge-weight tensor from an edge list of grid
    labels (adjacent only within +-2 cells), so that custom edge weights
    ride :func:`solve_mrf_grid`.  Each (node, channel) slot receives one
    weight at most, so the two ``index_put_`` adds are exact in any order.

    :param edges: (E, 2) integer tensor
    :param valid: (E,) bool
    :param weights: (E,) float
    """
    gh, gw = cfg.grid_h, cfg.grid_w
    a = edges[:, 0].to(torch.int64)
    b = edges[:, 1].to(torch.int64)
    ay, ax = torch.div(a, gw, rounding_mode='floor'), a % gw
    by, bx = torch.div(b, gw, rounding_mode='floor'), b % gw

    def chan(dy, dx):
        return (torch.clamp(dy, -2, 2) + 2) * 5 + (torch.clamp(dx, -2, 2) + 2)

    w = torch.where(valid, weights.to(torch.float32), 0.0)
    wg = torch.zeros(gh * gw * 25, dtype=torch.float32, device=w.device)
    wg.index_put_((a * 25 + chan(by - ay, bx - ax),), w, accumulate=True)
    wg.index_put_((b * 25 + chan(ay - by, ax - bx),), w, accumulate=True)
    return wg.reshape(gh, gw, 25)


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


# --------------------------- connectivity enforcement + min-size merge ---

def _enforce_route(cfg: SlicConfig):
    """The reference's route for this geometry: ``'fused'`` (row 12, seed +
    reach + absorb in one kernel) where its band fits, else the anchor seed
    and ``'rafused'`` (row 14, reach + absorb in one launch) or ``'two'``
    (row 13, two launches; also where the reference falls back to its XLA
    scans)."""
    from pyimsegm_tpu_torch.ops import connectivity_cuda as cc
    if cc.fused_fits(cfg):
        return 'fused'
    return 'rafused' if cc.fused_ra_fits(cfg) else 'two'


def enforce_grid_connectivity(labels, cfg: SlicConfig, min_size=None,
                              centers=None):
    """Make every superpixel a single 4-connected region.

    Anchor each superpixel at its pixels nearest its centroid, reach from
    the anchors through same-label runs, let unreached pixels take the label
    of their nearest reached neighbour inside their 3x3 seed window, then
    optionally merge superpixels below ``min_size`` (:func:`min_size_merge`).
    The route follows the image width as the reference's does
    (:func:`_enforce_route`): :func:`pyimsegm_tpu_torch.ops.enforce_cuda.
    enforce_fused`, or :func:`~pyimsegm_tpu_torch.ops.enforce_cuda.
    anchor_seed` and then :mod:`pyimsegm_tpu_torch.ops.connectivity_cuda`;
    every route gives the same labels.

    :param labels: (H, W) int32 grid-structured SLIC labels
    :param min_size: merge superpixels with fewer pixels into a neighbour
    :param centers: optional (K, 2) centroids in (y, x); reduced from the
        labels when not given
    :returns: (H, W) int32 labels, connected per superpixel
    """
    from pyimsegm_tpu_torch.ops import connectivity_cuda, enforce_cuda
    labels = labels.to(torch.int32).contiguous()
    if centers is None:
        h, w = labels.shape
        zeros = torch.zeros((h, w, 3), dtype=torch.float32,
                            device=labels.device)
        sums = grid_geometry_moments(zeros, labels, cfg)
        cyx = sums[:, 7:9] / torch.clamp_min(sums[:, 6:7], 1.0)
    else:
        cyx = centers.to(torch.float32)
    route = _enforce_route(cfg)
    if route == 'fused':
        labels = enforce_cuda.enforce_fused(labels, cyx, cfg)
    else:
        reached0 = enforce_cuda.anchor_seed(labels, cyx, cfg)
        connect = (connectivity_cuda.reach_absorb_fused if route == 'rafused'
                   else connectivity_cuda.reach_absorb)
        labels = connect(labels, reached0, cfg)
    if min_size:
        labels = min_size_merge(labels, cfg, min_size)
    return labels


def enforce_minsize_with_moments(labels, cfg: SlicConfig, min_size, centers,
                                 feat):
    """Connectivity enforcement + min-size merge + geometry/moments reduce:
    the donor apply and the re-reduce are one pass
    (:func:`grid_cuda.grid_moments_apply`).

    :param feat: (H, W, F) float feature image reduced over the final labels
    :returns: (labels (H, W) i32, sums (K, 2F+3) f32)
    """
    labels = enforce_grid_connectivity(labels, cfg, min_size=None,
                                       centers=centers)
    if not min_size:
        return labels, grid_geometry_moments(feat, labels, cfg)
    counts, sym25, counts9 = counts_and_contacts(labels, cfg)
    donor = donor_chain_table(counts, sym25, cfg.grid_h, cfg.grid_w,
                              min_size, counts9=counts9)
    return grid_cuda.grid_moments_apply(feat, labels, donor, cfg)


def sym_contact_counts(cnt25_directed, gh, gw):
    """Symmetrise directed (gh, gw, 25) boundary-pair counts: contact(A, B)
    = directed(A -> B) + directed(B -> A) routed back through the flipped
    channel."""
    perm = _flip_channel_perm()
    partner = torch.stack(
        [_shift2d(cnt25_directed[..., perm[ci]], -dy, -dx)
         for ci, (dy, dx) in enumerate(GRAPH_OFFSETS)], dim=-1)
    return cnt25_directed + partner


def grid_pair_count_channels(labels, cfg: SlicConfig):
    """Raw directed (gh, gw, 25) conn4 boundary-contact counts."""
    from pyimsegm_tpu_torch.ops.slic_cuda import combine_sums
    return combine_sums(grid_cuda.grid_pair_count(labels, cfg)[0])


def counts_and_contacts(labels, cfg: SlicConfig):
    """Per-superpixel pixel counts, symmetric boundary-contact counts and
    the per-(tile, offset) pixel counts: the measurement behind the
    min-size merge, one pass over the pixels and its route
    (:func:`grid_cuda.counts_and_contacts`: two CUDA kernels on the card).

    :returns: (counts (K,) f32, sym25 (gh, gw, 25) f32, counts9 (gh, gw, 9)
        f32)
    """
    return grid_cuda.counts_and_contacts(labels, cfg)


def _neighbor_index(gh, gw, device):
    """(gh, gw, 25) flat index of the seed at each GRAPH_OFFSETS channel
    (clipped to the grid) and whether it lies on the grid."""
    oy = torch.arange(gh, device=device)[:, None, None]
    ox = torch.arange(gw, device=device)[None, :, None]
    dy = torch.tensor([d[0] for d in GRAPH_OFFSETS], device=device)
    dx = torch.tensor([d[1] for d in GRAPH_OFFSETS], device=device)
    ny, nx = oy + dy, ox + dx
    valid = (ny >= 0) & (ny < gh) & (nx >= 0) & (nx < gw)
    return ny.clamp(0, gh - 1) * gw + nx.clamp(0, gw - 1), valid


def _best_channel(score, nidx, self_idx):
    """Per cell, the neighbour of the first channel with the largest score
    (the sequential strict ``>`` scan over channels of the reference), and
    that score; -1 and the cell itself where no score beats -1."""
    best = score.amax(dim=-1)
    pick = torch.take_along_dim(nidx, score.argmax(dim=-1, keepdim=True),
                                dim=-1)[..., 0]
    return best, torch.where(best > -1.0, pick, self_idx)


def donor_table_from_counts(counts, sym25, gh, gw, min_size):
    """Per-label merge targets for the min-size phase: the kept (not small)
    grid neighbour with maximum boundary contact.

    :returns: (donor (K,) int64 -- target label, or the label itself; small
        (K,) bool)
    """
    k = gh * gw
    small = counts < float(min_size)
    idx = torch.arange(k, device=counts.device)
    nidx, valid = _neighbor_index(gh, gw, counts.device)
    kept = ~small[nidx] & valid
    score = torch.where(kept, sym25, -1.0)
    best, pick = _best_channel(score, nidx, idx.reshape(gh, gw))
    donor = torch.where(small.reshape(gh, gw) & (best > 0.0), pick,
                        idx.reshape(gh, gw))
    return donor.reshape(k), small


def label_tile_extents(counts9, gh, gw):
    """Per-label extent of the tiles its pixels occupy.

    :param counts9: (gh, gw, 9) pixel counts per tile and routing offset
    :returns: (ty_min, ty_max, tx_min, tx_max), each (K,) int64; empty
        labels get their own grid cell
    """
    dev = counts9.device
    oy = torch.arange(gh, device=dev)[:, None, None]
    ox = torch.arange(gw, device=dev)[None, :, None]
    di = torch.tensor([o[0] for o in _OFFSETS], device=dev)
    dj = torch.tensor([o[1] for o in _OFFSETS], device=dev)
    # tile (y - di, x - dj) holds pixels of label (y, x) under offset idx
    m = torch.stack([_shift2d(counts9[:, :, idx], di_, dj_)
                     for idx, (di_, dj_) in enumerate(_OFFSETS)], dim=-1) > 0
    ty_min = torch.where(m, oy - di, _BIG).amin(dim=-1)
    ty_max = torch.where(m, oy - di, -_BIG).amax(dim=-1)
    tx_min = torch.where(m, ox - dj, _BIG).amin(dim=-1)
    tx_max = torch.where(m, ox - dj, -_BIG).amax(dim=-1)
    empty = ty_min == _BIG
    oy, ox = oy[..., 0].expand(gh, gw), ox[..., 0].expand(gh, gw)
    return tuple(torch.where(empty, fill, t).reshape(-1) for t, fill in
                 ((ty_min, oy), (ty_max, oy), (tx_min, ox), (tx_max, ox)))


def donor_chain_table(counts, sym25, gh, gw, min_size, n_hops=3,
                      counts9=None):
    """Fully-resolved merge targets from a single measurement.

    A small label with no kept neighbour points at its max-contact small
    neighbour that is strictly greater in ``(count, -index)`` order (so the
    pointer graph is acyclic), and the table is squared ``n_hops`` times.
    With ``counts9``, a merge fires only when its terminal lies in the 3x3
    seed window of every tile the source occupies, and every link of its
    chain fires too.  A chain that never reaches a kept label leaves its
    members unchanged.

    :returns: (K,) int64 -- final kept target per label, or the label itself
    """
    k = gh * gw
    donor, small = donor_table_from_counts(counts, sym25, gh, gw, min_size)
    idx = torch.arange(k, device=counts.device)

    # fallback pointers for small labels whose whole neighbourhood is small
    nidx, valid = _neighbor_index(gh, gw, counts.device)
    cnt = counts.to(torch.float32)
    cnt_g = cnt.reshape(gh, gw)[..., None]
    self_g = idx.reshape(gh, gw)
    ncnt = cnt[nidx]
    greater = (ncnt > cnt_g) | ((ncnt == cnt_g) & (nidx < self_g[..., None]))
    score = torch.where(small[nidx] & valid & greater, sym25, -1.0)
    best, pick = _best_channel(score, nidx, self_g)
    fb = torch.where(best.reshape(k) > 0.0, pick.reshape(k), idx)

    d1 = torch.where(small & (donor == idx), fb, donor)
    d = d1
    for _ in range(max(int(n_hops), 1)):
        d = d[d]
    fire = small & ~small[d]
    if counts9 is not None:
        ty_min, ty_max, tx_min, tx_max = label_tile_extents(counts9, gh, gw)
        dy, dx = d // gw, d % gw
        ok = ((dy - ty_min).abs() <= 1) & ((dy - ty_max).abs() <= 1) \
            & ((dx - tx_min).abs() <= 1) & ((dx - tx_max).abs() <= 1) | ~small
        dd = d1
        for _ in range(max(int(n_hops), 1)):
            ok = ok & ok[dd]
            dd = dd[dd]
        fire = fire & ok
    return torch.where(fire, d, idx)


def min_size_merge(labels, cfg: SlicConfig, min_size, n_rounds=3):
    """Merge whole superpixels below ``min_size`` into their max-contact
    kept neighbour (:func:`donor_chain_table`); a pixel whose donor seed
    falls outside its own 3x3 tile window keeps its label."""
    h, w = labels.shape
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    ty = torch.arange(h, device=labels.device)[:, None] // step
    tx = torch.arange(w, device=labels.device)[None, :] // step
    counts, sym25, counts9 = counts_and_contacts(labels, cfg)
    donor = donor_chain_table(counts, sym25, gh, gw, min_size,
                              n_hops=n_rounds, counts9=counts9)
    new = grid_lookup(donor.to(torch.int32), labels, cfg).to(torch.int64)
    ok = ((new // gw - ty).abs() <= 1) & ((new % gw - tx).abs() <= 1)
    return torch.where(ok, new, labels.to(torch.int64)).to(torch.int32)
