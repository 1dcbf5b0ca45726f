"""Row-sharded SLIC and the tiled unsupervised pipeline: one large image
split into bands of pixel rows over a device mesh (port of
``pyimsegm_tpu.parallel.tiled``).

SPMD, one process per card (``parallel.batch.make_mesh``): every rank is
given the whole image, does the cheap replicated preprocessing (blur, Lab,
the seed grid) and then keeps its own band of ``lgh * step`` pixel rows,
``lgh`` seed-tile rows of the padded image.  The centre table and every
per-superpixel table (a few hundred KB at most) are replicated.  Each SLIC
iteration assigns the band's pixels against the replicated centres, sums
them by tile and by 3x3 offset, routes the sums to the seeds of a haloed
frame and reduces the frame over the mesh with one ``all_reduce``.  The
full pipeline adds the connectivity enforcement, whose reach and absorb
steps exchange one boundary pixel row with each neighbouring band
(``all_gather`` of every band's first and last row), the colour moments
and the pair counts (one ``all_reduce`` each); the GMM fit, the edge
weights and the grid MRF then run replicated on every rank.  Every rank
returns the full maps (``all_gather`` of the bands).

The stages are plain PyTorch on the mesh's device, as the JAX module is
plain XLA; the per-pixel counts are integer ``index_add_`` sums, the float
sums masked tile reductions.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from pyimsegm_tpu_torch.ops.segment_stats import moment_features
from pyimsegm_tpu_torch.ops.slic import (  # noqa: F401
    SlicConfig,
    _BIG,
    _edge_pad_chw,
    _prepare_image,
    _seed_centers,
    compactness_from_regul,
    slic_config,
)
from pyimsegm_tpu_torch.parallel.batch import (all_gather_cat, make_mesh,
                                               mesh_device, mesh_rank)
from pyimsegm_tpu_torch.pipelines import _features_spec, _fusable_color_spec
from pyimsegm_tpu_torch.utils.device import count, stage_range

_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]
_CONN4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
#: reach and absorb steps between two reads of the all-reduced "changed"
#: flag (one host synchronisation each); a step after convergence changes
#: nothing, so the labels equal those of a check after every step
CHECK_EVERY = 4


class _Band(NamedTuple):
    """This rank's band: the geometry, its first tile row ``t0`` and its
    ``lgh`` tile rows, its place on the mesh and the mesh's group."""
    cfg: SlicConfig
    lgh: int
    t0: int
    rank: int
    size: int
    group: object
    device: torch.device

    @property
    def hb(self):
        return self.lgh * self.cfg.step


def _shard_rows(cfg: SlicConfig, n_devices):
    """Local tile-row count; grid rows must split evenly over devices."""
    if cfg.grid_h % n_devices != 0:
        raise ValueError('grid rows (%i) must be divisible by devices (%i); '
                         'pick sp_size or pad accordingly'
                         % (cfg.grid_h, n_devices))
    return cfg.grid_h // n_devices


def _band(cfg, mesh):
    rank, size = mesh_rank(mesh)
    lgh = _shard_rows(cfg, size)
    return _Band(cfg, lgh, rank * lgh, rank, size, mesh.get_group(0),
                 mesh_device(mesh))


def _all_reduce(tensor, band, op=dist.ReduceOp.SUM):
    with stage_range('exchange'):
        dist.all_reduce(tensor, op=op, group=band.group)
    return tensor


def _any_changed(new, old, band):
    """Whether ``new`` differs from ``old`` on any rank (one host sync,
    counted as ``mesh_flag_syncs`` while tracing)."""
    count('mesh_flag_syncs')
    flag = torch.any(new != old).to(torch.int32).reshape(1)
    with stage_range('exchange'):
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=band.group)
        return bool(flag.item())


def _gather_rows(tensor, mesh, cfg):
    """Every band of ``tensor`` in mesh order, cropped to the image (one
    ``all_gather``)."""
    with stage_range('exchange'):
        return all_gather_cat(tensor, mesh)[:cfg.height, :cfg.width]


def _tile_rows(band):
    """(hb, 1) global tile row and (1, wp) tile column of every pixel."""
    step = band.cfg.step
    dev = band.device
    ty = torch.arange(band.hb, dtype=torch.int32, device=dev) // step \
        + band.t0
    tx = torch.arange(band.cfg.pad_w, dtype=torch.int32, device=dev) // step
    return ty[:, None], tx[None, :]


def _pixel_coords(band):
    """(hb, 1) global row and (1, wp) column of every pixel, as f32."""
    dev = band.device
    py = torch.arange(band.hb, dtype=torch.float32, device=dev) \
        + float(band.t0 * band.cfg.step)
    px = torch.arange(band.cfg.pad_w, dtype=torch.float32, device=dev)
    return py[:, None], px[None, :]


def _floor_divmod(labels, gw):
    q = torch.div(labels, gw, rounding_mode='floor')
    return q, labels - q * gw


# ------------------------------------------------------------ sharded SLIC --

def _shift_cols(grid, dj, fill):
    """out[:, x] = grid[:, x + dj], ``fill`` where that leaves the grid."""
    if dj == 0:
        return grid
    edge = torch.full_like(grid[:, :1], fill)
    if dj > 0:
        return torch.cat([grid[:, dj:], edge.expand_as(grid[:, :dj])], 1)
    return torch.cat([edge.expand_as(grid[:, dj:]), grid[:, :dj]], 1)


def _route(part_halo, part, di, dj, combine=torch.add):
    """Combine a (lgh, gw, ...) per-tile partial of the pixels whose label
    sits at grid offset (di, dj) into the (lgh + 2, gw, ...) halo frame of
    the labels' seeds (``combine(frame, partial)``, a sum by default); what
    leaves the grid's columns is dropped."""
    lgh, gw = part.shape[:2]
    rows = slice(1 + di, 1 + di + lgh)
    dst = slice(max(dj, 0), gw + min(dj, 0))
    src = slice(max(-dj, 0), gw + min(-dj, 0))
    part_halo[rows, dst] = combine(part_halo[rows, dst], part[:, src])


def _psum_halo(part_halo, band):
    """Place a local (lgh + 2, gw, F) halo frame into the global frame and
    sum it over the mesh; returns (gh, gw, F)."""
    gh = band.cfg.grid_h
    glob = torch.zeros((gh + 2,) + tuple(part_halo.shape[1:]),
                       dtype=torch.float32, device=band.device)
    glob[band.t0:band.t0 + band.lgh + 2] = part_halo
    return _all_reduce(glob, band)[1:gh + 1]


def _local_slic_iter(lab_t, data_t, centers, band, spatial_w2,
                     update=True):
    """One assignment of the band's pixels to the best of the 3x3 seeds
    around their tile, then (``update``) the centres from the mesh-reduced
    tile sums.

    :param lab_t: (3, lgh, step, gw, step) Lab planes of the band
    :param data_t: (6, lgh, step, gw, step) [L, a, b, y, x, 1] * valid
    :param centers: (gh, gw, 5) replicated centres
    :returns: (labels (hb, wp) int32, new centres or None)
    """
    cfg, lgh, t0 = band.cfg, band.lgh, band.t0
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = band.device
    sent = torch.full((1, gw, 5), _BIG, dtype=torch.float32, device=dev)
    halo = torch.cat([sent, centers, sent])[t0:t0 + lgh + 2]
    py, px = _pixel_coords(band)
    py = py.reshape(lgh, step, 1, 1)
    px = px.reshape(1, 1, gw, step)
    ty = torch.arange(lgh, device=dev)[:, None] + t0
    tx = torch.arange(gw, device=dev)[None, :]

    shape = (lgh, step, gw, step)
    best_d = torch.full(shape, _BIG, dtype=torch.float32, device=dev)
    best_o = torch.zeros(shape, dtype=torch.int8, device=dev)
    best_lb = torch.zeros(shape, dtype=torch.int32, device=dev)
    for oi, (di, dj) in enumerate(_OFFSETS):
        nb = _shift_cols(halo[1 + di:1 + di + lgh], dj, _BIG)
        sy, sx = ty + di, tx + dj
        inb = (sy >= 0) & (sy < gh) & (sx >= 0) & (sx < gw)
        nb = torch.where(inb[..., None], nb, _BIG)[:, None, :, None]
        nb_id = torch.where(inb, sy * gw + sx, 0).to(torch.int32)
        dl = lab_t[0] - nb[..., 0]
        dc2 = dl * dl
        dl = lab_t[1] - nb[..., 1]
        dc2 = dc2 + dl * dl
        dl = lab_t[2] - nb[..., 2]
        dc2 = dc2 + dl * dl
        ds2 = (py - nb[..., 3]) ** 2 + (px - nb[..., 4]) ** 2
        d = dc2 + ds2 * spatial_w2
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_o = torch.where(take, oi, best_o)
        best_lb = torch.where(take, nb_id[:, None, :, None], best_lb)
    labels = best_lb.reshape(band.hb, cfg.pad_w)
    if not update:
        return labels, None

    part_halo = torch.zeros((lgh + 2, gw, 6), dtype=torch.float32,
                            device=dev)
    for oi, (di, dj) in enumerate(_OFFSETS):
        mask = (best_o == oi).to(torch.float32)
        part = (data_t * mask).sum(dim=(2, 4)).permute(1, 2, 0)
        _route(part_halo, part, di, dj)
    sums = _psum_halo(part_halo, band)
    cnt = sums[..., 5:6]
    new_centers = torch.where(cnt > 0,
                              sums[..., :5] / torch.clamp_min(cnt, 1.0),
                              centers)
    return labels, new_centers


def _slic_band(lab_loc, valid_loc, centers, band, spatial_w2, n_iter):
    """n_iter - 1 update rounds, then the final assignment (skimage's
    iteration order, as ``ops/slic.py``); returns the band's labels.

    :param lab_loc: (3, hb, wp) Lab planes of the band
    :param valid_loc: (hb, wp) 1 on the image, 0 on its padding
    """
    tiles = (band.lgh, band.cfg.step, band.cfg.grid_w, band.cfg.step)
    py, px = _pixel_coords(band)
    coords = torch.stack(torch.broadcast_tensors(py, px))     # (2, hb, wp)
    data_t = torch.cat([lab_loc, coords, torch.ones_like(coords[:1])]) \
        * valid_loc
    lab_t = lab_loc.reshape((3,) + tiles)
    data_t = data_t.reshape((6,) + tiles)
    for _ in range(max(n_iter - 1, 0)):
        _lbl, centers = _local_slic_iter(lab_t, data_t, centers, band,
                                         spatial_w2)
    return _local_slic_iter(lab_t, data_t, centers, band, spatial_w2,
                            update=False)[0]


def _spatial_w2(sp_size, sp_regul, cfg):
    """``(m / step) ** 2`` rounded as f32 arithmetic does."""
    m = np.float32(compactness_from_regul(sp_size, sp_regul))
    return float((m / np.float32(cfg.step)) ** 2)


def _zero_pad(arr, cfg):
    out = torch.zeros((cfg.pad_h, cfg.pad_w) + tuple(arr.shape[2:]),
                      dtype=arr.dtype, device=arr.device)
    out[:cfg.height, :cfg.width] = arr
    return out


def _prepare(image, cfg, band, round_seeds):
    """Replicated preprocessing: the edge-padded Lab planes rounded through
    bf16, the valid mask and the seed centres (their colours sampled from
    the unpadded Lab, rounded through bf16 with ``round_seeds``); returns
    the band's (lab (3, hb, wp), valid (hb, wp)) and the (gh, gw, 5)
    centres."""
    lab_chw = _prepare_image(image).permute(2, 0, 1)
    lab_p = _edge_pad_chw(lab_chw, cfg).to(torch.bfloat16).to(torch.float32)
    centers0 = _seed_centers(
        lab_chw.to(torch.bfloat16) if round_seeds else lab_chw, cfg)
    valid = _zero_pad(torch.ones(lab_chw.shape[1:], dtype=torch.float32,
                                 device=lab_chw.device), cfg)
    rows = slice(band.t0 * cfg.step, band.t0 * cfg.step + band.hb)
    return (lab_p[:, rows].contiguous(), valid[rows].contiguous(),
            centers0)


def _to_host(tensor):
    """``tensor`` as a host numpy array.  A card's tensor is copied into
    page-locked memory from PyTorch's caching host allocator: the copy runs
    at the link's speed, not through the driver's pageable staging and the
    page faults of a fresh array, and the block returns to the cache once
    the array is dropped."""
    if tensor.device.type != 'cuda':
        return tensor.cpu().numpy()
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    out.copy_(tensor)
    return out.numpy()


def slic_segment_sharded(image, sp_size, sp_regul, mesh=None, n_iter=10,
                         axis_name='rows'):
    """Distributed SLIC of one large image over a device mesh.

    The pixel buffer and the sampled seed colours are both rounded through
    bf16, as ``ops/slic.py`` does, so the sharded and single-card paths
    assign from the same values.

    :param image: (H, W, 3) float array or tensor, the whole image on every
        rank
    :param mesh: 1D mesh (``parallel.batch.make_mesh``); by default
        ``make_mesh(axis_name=axis_name)`` over the world
    :returns: (H, W) int32 labels (host numpy), on every rank
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    dev = mesh_device(mesh)
    image = torch.as_tensor(image, device=dev)
    cfg = slic_config(image.shape[0], image.shape[1], sp_size)
    band = _band(cfg, mesh)
    lab_loc, valid_loc, centers0 = _prepare(image, cfg, band,
                                            round_seeds=True)
    labels = _slic_band(lab_loc, valid_loc, centers0, band,
                        _spatial_w2(sp_size, sp_regul, cfg), n_iter)
    return _gather_rows(labels, mesh, cfg).cpu().numpy()


# ===================================================================
# full tiled pipeline: SLIC -> connectivity -> features -> model ->
# adjacency/edge weights -> MRF, one large image sharded by pixel rows.
# Per-pixel stages stay sharded; every per-superpixel table is reduced
# with one all_reduce and the superpixel-level stages (GMM fit, edge
# weights, the grid MRF) run replicated on each rank.
# ===================================================================

def _row_exchange(first, last, band, fill):
    """Give every band its neighbours' boundary rows: returns (above,
    below), the upper neighbour's last row and the lower neighbour's first
    row (``fill`` at the mesh's edges), by one ``all_gather`` of every
    band's first and last rows.

    :param first: this band's first row (any shape, int32)
    :param last: this band's last row (same shape)
    :param fill: tensor of that shape for the mesh's edges
    """
    rows = torch.stack([first, last])
    parts = [torch.empty_like(rows) for _ in range(band.size)]
    with stage_range('exchange'):
        dist.all_gather(parts, rows, group=band.group)
    above = parts[band.rank - 1][1] if band.rank > 0 else fill
    below = parts[band.rank + 1][0] if band.rank < band.size - 1 else fill
    return above, below


def _local_offsets(labels_loc, band):
    """Per-pixel 3x3 routing offset of each label w.r.t. its global tile;
    returns (off (hb, wp) in [0, 9), -1 where not ok; ok mask)."""
    ty, tx = _tile_rows(band)
    ly, lx = _floor_divmod(labels_loc, band.cfg.grid_w)
    dy = ly - ty + 1
    dx = lx - tx + 1
    ok = (labels_loc >= 0) & (dy >= 0) & (dy < 3) & (dx >= 0) & (dx < 3)
    return torch.where(ok, dy * 3 + dx, -1), ok


def _local_segment_sum(data_loc, labels_loc, band):
    """(K, F) per-superpixel sums of the band's pixel data (one
    ``all_reduce``)."""
    cfg, lgh = band.cfg, band.lgh
    gw, step = cfg.grid_w, cfg.step
    f = data_loc.shape[-1]
    off, _ = _local_offsets(labels_loc, band)
    part_halo = torch.zeros((lgh + 2, gw, f), dtype=torch.float32,
                            device=band.device)
    for oi, (di, dj) in enumerate(_OFFSETS):
        mask = (off == oi).to(torch.float32)[..., None]
        part = (data_loc * mask).reshape(lgh, step, gw, step, f).sum((1, 3))
        _route(part_halo, part, di, dj)
    return _psum_halo(part_halo, band).reshape(cfg.n_segments, f)


def _local_segment_min(value_loc, labels_loc, band):
    """(K,) per-superpixel minimum of the band's pixel map (one
    ``all_reduce(MIN)``); +inf for an empty superpixel."""
    cfg, lgh = band.cfg, band.lgh
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    off, _ = _local_offsets(labels_loc, band)
    inf = float('inf')
    part_halo = torch.full((lgh + 2, gw), inf, dtype=torch.float32,
                           device=band.device)
    for oi, (di, dj) in enumerate(_OFFSETS):
        part = torch.where(off == oi, value_loc, inf) \
            .reshape(lgh, step, gw, step).amin((1, 3))
        _route(part_halo, part, di, dj, torch.minimum)
    glob = torch.full((gh + 2, gw), inf, dtype=torch.float32,
                      device=band.device)
    glob[band.t0:band.t0 + lgh + 2] = part_halo
    return _all_reduce(glob, band, dist.ReduceOp.MIN)[1:gh + 1].reshape(-1)


def _local_table_lookup(table, labels_loc, band):
    """Per-pixel ``table[label]`` of a replicated (K, C) table on the band;
    0 where the label lies outside its pixel's 3x3 seed window (or is
    negative)."""
    _, ok = _local_offsets(labels_loc, band)
    ok = ok & (labels_loc < band.cfg.n_segments)
    vals = table.to(torch.float32)[torch.where(ok, labels_loc, 0).long()]
    return torch.where(ok[..., None], vals, 0.0)


def _nbr(pad2, di, dj, fill):
    """The (hb, wp) map of each pixel's neighbour at (di, dj), from a map
    padded with one row above and below; ``fill`` beyond the columns."""
    return _shift_cols(pad2[1 + di:pad2.shape[0] - 1 + di], dj, fill)


def _local_enforce_connectivity(labels_loc, band):
    """Sharded ``ops.grid.enforce_grid_connectivity``: anchors at the
    pixels nearest each superpixel's centroid (one sum and one min over the
    mesh), reach from them through same-label pixels, absorb the unreached
    (one boundary-row exchange a step each), then the min-size merge with
    the replicated donor tables of the single-card path."""
    from pyimsegm_tpu_torch.ops.grid import (_shift2d, donor_chain_table,
                                             sym_contact_counts)
    cfg, lgh = band.cfg, band.lgh
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = band.device
    py, px = _pixel_coords(band)
    py, px = torch.broadcast_tensors(py, px)
    geo = torch.stack([torch.ones_like(py), py, px], dim=-1)
    sums = _local_segment_sum(geo, labels_loc, band)
    cyx = sums[:, 1:3] / torch.clamp_min(sums[:, 0:1], 1.0)
    cpix = _local_table_lookup(cyx, labels_loc, band)
    d2 = (py - cpix[..., 0]) ** 2 + (px - cpix[..., 1]) ** 2
    d2min = _local_segment_min(d2, labels_loc, band)
    dmin_pix = _local_table_lookup(d2min[:, None], labels_loc, band)[..., 0]
    reached = (d2 <= dmin_pix + 1e-3) & (labels_loc >= 0)

    # reach: labels static, the band's boundary rows of reached exchanged
    # every step
    no = torch.full_like(labels_loc[0], -1)
    above, below = _row_exchange(labels_loc[0], labels_loc[-1], band, no)
    lab_pad = torch.cat([above[None], labels_loc, below[None]])
    same = [_nbr(lab_pad, di, dj, -1) == labels_loc for di, dj in _CONN4]
    zero = torch.zeros_like(labels_loc[0])
    it = 0
    while it < 4 * step:
        above, below = _row_exchange(reached[0].to(torch.int32),
                                     reached[-1].to(torch.int32), band, zero)
        rch_pad = torch.cat([above[None].bool(), reached, below[None].bool()])
        new = reached
        for (di, dj), s in zip(_CONN4, same):
            new = new | (_nbr(rch_pad, di, dj, False) & s)
        it += 1
        check = it % CHECK_EVERY == 0 and it < 4 * step
        done = check and not _any_changed(new, reached, band)
        reached = new
        if done:
            break

    labels_loc = _local_absorb_unreached(labels_loc, reached, band)

    # min-size merge (skimage semantics): the donor tables of the single-
    # card ops.grid.min_size_merge, from counts and contacts reduced over
    # the mesh, so both take the same merge decisions
    min_size = int(0.5 * step * step)
    ty, tx = _tile_rows(band)
    off9, _ = _local_offsets(labels_loc, band)
    tile = (ty - band.t0) * gw + tx
    counts9_loc = _count_bins(torch.where(off9 >= 0, tile * 9 + off9, -1),
                              lgh * gw * 9).reshape(lgh, gw, 9)
    counts9 = torch.zeros((gh, gw, 9), dtype=torch.float32, device=dev)
    counts9[band.t0:band.t0 + lgh] = counts9_loc
    counts9 = _all_reduce(counts9, band)
    counts_g = torch.zeros((gh, gw), dtype=torch.float32, device=dev)
    for idx, (di, dj) in enumerate(_OFFSETS):
        counts_g = counts_g + _shift2d(counts9[:, :, idx], di, dj)
    raw = _local_pair_counts(labels_loc, band)
    sym25 = sym_contact_counts(raw, gh, gw)
    donor = donor_chain_table(counts_g.reshape(-1), sym25, gh, gw, min_size,
                              counts9=counts9)
    new = torch.round(_local_table_lookup(
        donor[:, None].to(torch.float32), labels_loc, band)[..., 0]) \
        .to(torch.int32)
    ny, nx = _floor_divmod(new, gw)
    ok = ((ny - ty).abs() <= 1) & ((nx - tx).abs() <= 1)
    return torch.where(ok, new, labels_loc)


def _count_bins(index, n):
    """(n,) f32 counts of the non-negative entries of an int map (integer
    adds, so exact in any order)."""
    index = torch.where(index >= 0, index, n).reshape(-1).long()
    counts = torch.zeros(n + 1, dtype=torch.int32, device=index.device)
    counts.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))
    return counts[:n].to(torch.float32)


def _local_absorb_unreached(labels_loc, reached, band):
    """Sharded absorb: unreached pixels adopt an adjacent reached label
    (within their 3x3 seed window), one boundary-row exchange (labels and
    reached together) per step."""
    gw, step = band.cfg.grid_w, band.cfg.step
    ty, tx = _tile_rows(band)
    fill = torch.stack([torch.full_like(labels_loc[0], -1),
                        torch.zeros_like(labels_loc[0])])
    it = 0
    while it < 2 * step:
        above, below = _row_exchange(
            torch.stack([labels_loc[0], reached[0].to(torch.int32)]),
            torch.stack([labels_loc[-1], reached[-1].to(torch.int32)]),
            band, fill)
        lab_pad = torch.cat([above[0][None], labels_loc, below[0][None]])
        rch_pad = torch.cat([above[1][None].bool(), reached,
                             below[1][None].bool()])
        got = reached
        best = labels_loc
        for di, dj in _CONN4:
            nl = _nbr(lab_pad, di, dj, -1)
            nr = _nbr(rch_pad, di, dj, False)
            ny, nx = _floor_divmod(nl, gw)
            in_win = ((ny - ty).abs() <= 1) & ((nx - tx).abs() <= 1) \
                & (nl >= 0)
            take = nr & ~got & in_win & (labels_loc >= 0)
            best = torch.where(take, nl, best)
            got = got | take
        labels_loc = torch.where(got, best, labels_loc)
        it += 1
        check = it % CHECK_EVERY == 0 and it < 2 * step
        done = check and not _any_changed(got, reached, band)
        reached = got
        if done:
            break
    return labels_loc


def _local_pair_counts(labels_loc, band):
    """(gh, gw, 25) replicated directed superpixel contact counts from the
    band's conn4 pixel pairs (one boundary-row exchange + one
    ``all_reduce``)."""
    lgh, gw = band.lgh, band.cfg.grid_w
    no = torch.full_like(labels_loc[0], -1)
    _, below = _row_exchange(labels_loc[0], labels_loc[-1], band, no)
    ty, tx = _tile_rows(band)
    ga_y, ga_x = _floor_divmod(labels_loc, gw)
    oa_y = ga_y - ty + 1
    oa_x = ga_x - tx + 1
    tile = (ty - band.t0) * gw + tx
    base = labels_loc >= 0
    base = base & (oa_y >= 0) & (oa_y < 3) & (oa_x >= 0) & (oa_x < 3)
    slot = (tile * 9 + oa_y * 3 + oa_x) * 25

    def bins(b):
        by, bx = _floor_divmod(b, gw)
        dy = by - ga_y
        dx = bx - ga_x
        ok = base & (labels_loc != b) & (b >= 0) & (dy.abs() <= 2) \
            & (dx.abs() <= 2)
        return torch.where(ok, slot + (dy + 2) * 5 + (dx + 2), -1)

    b_h = torch.cat([labels_loc[:, 1:],
                     torch.full_like(labels_loc[:, :1], -2)], 1)
    b_v = torch.cat([labels_loc[1:], below[None]])
    cnt9 = _count_bins(torch.stack([bins(b_h), bins(b_v)]),
                       lgh * gw * 225).reshape(lgh, gw, 9, 25)
    part_halo = torch.zeros((lgh + 2, gw, 25), dtype=torch.float32,
                            device=band.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        _route(part_halo, cnt9[:, :, idx], di, dj)
    return _psum_halo(part_halo, band)


def _local_adjacency(labels_loc, band):
    from pyimsegm_tpu_torch.ops.grid import _sym_mask_adjacency
    adj_raw = _local_pair_counts(labels_loc, band)
    return _sym_mask_adjacency(adj_raw, band.cfg.grid_h, band.cfg.grid_w)


def _tiled_pipe_shard(lab_loc, valid_loc, feat_loc, centers0, spatial_w2,
                      pairwise, *, band, n_iter, flags, nb_classes,
                      estim_model, gc_edge_type, seed, connectivity,
                      debug=None):
    """One rank's part of the tiled pipeline; returns its band of the hard
    and soft maps, (hb, wp) int32 and (hb, wp, C) f32.  A ``debug`` dict
    receives the band's enforced labels (``labels_loc``) and the
    replicated ``features``, ``model`` and ``proba``."""
    from pyimsegm_tpu_torch.models.class_model import estim_class_model
    from pyimsegm_tpu_torch.ops.graphcut import compute_unary_cost
    from pyimsegm_tpu_torch.ops.grid import grid_edge_weights, solve_mrf_grid

    cfg = band.cfg
    with stage_range('slic'):
        labels_loc = _slic_band(lab_loc, valid_loc, centers0, band,
                                spatial_w2, n_iter)
        # padded pixels must not join or spread a superpixel (the unsharded
        # path crops before enforcement and adjacency)
        labels_loc = torch.where(valid_loc > 0, labels_loc, -1)
    if connectivity:
        with stage_range('enforce'):
            labels_loc = _local_enforce_connectivity(labels_loc, band)

    with stage_range('features'):
        py, px = _pixel_coords(band)
        py, px = torch.broadcast_tensors(py, px)
        data = torch.cat([feat_loc, feat_loc * feat_loc,
                          torch.ones_like(py)[..., None], py[..., None],
                          px[..., None]], dim=-1) * valid_loc[..., None]
        sums = _local_segment_sum(data, labels_loc, band)
        counts = sums[:, 6]
        sp_centers = sums[:, 7:9] / torch.clamp_min(counts[:, None], 1.0)
        features = moment_features(sums[:, :6], counts, flags)

    with stage_range('fit'):
        mask = (counts > 0).to(torch.float32)
        model = estim_class_model(features, nb_classes, estim_model,
                                  sample_weight=mask, seed=seed)
    with stage_range('predict_proba'):
        proba = model.predict_proba(features)

    with stage_range('edges'):
        adj = _local_adjacency(labels_loc, band)
        wgrid = grid_edge_weights(None, cfg, proba=proba, features=features,
                                  edge_type=gc_edge_type, adj=adj,
                                  centers=sp_centers)
    with stage_range('mrf'):
        class_lb = solve_mrf_grid(compute_unary_cost(proba), wgrid, pairwise,
                                  cfg)

    with stage_range('lookup'):
        segm_loc = torch.round(_local_table_lookup(
            class_lb.to(torch.float32)[:, None], labels_loc,
            band)[..., 0]).to(torch.int32)
        soft_loc = _local_table_lookup(proba, labels_loc, band)
    if debug is not None:
        debug.update(labels_loc=labels_loc, features=features, model=model,
                     proba=proba)
    return segm_loc, soft_loc


def pipe_color2d_slic_features_model_graphcut_tiled(
        image, nb_classes, dict_features, sp_size=30, sp_regul=0.2,
        estim_model='GMM', gc_regul=1.0, gc_edge_type='model', mesh=None,
        n_iter=10, seed=0, axis_name='rows', connectivity=True,
        debug_visual=None):
    """Unsupervised pipeline for one large image split into row bands over
    a device mesh: the distributed counterpart of
    :func:`pyimsegm_tpu_torch.pipelines.
    pipe_color2d_slic_features_model_graphcut`.

    Supported features: a single colour-space key with plain moment flags
    (mean / std / energy), the set the fused single-card path accelerates.
    The seed colours are not rounded through bf16 here, as in the JAX
    package's tiled pipeline.

    :param image: (H, W, 3) float array or tensor, the whole image on every
        rank
    :param mesh: 1D mesh (``parallel.batch.make_mesh``); by default
        ``make_mesh(axis_name=axis_name)`` over the world; the image's seed
        rows must split evenly over it
    :param seed: seed of the model fit's ``torch.Generator``
    :param debug_visual: optional dict that receives, on every rank, what
        the single-card entries hand back: the gathered enforced labels
        (``slic``, (H, W) int32), ``features`` (K, F), the fitted ``model``
        and ``proba`` (K, C), all host arrays but the model
    :returns: (segm (H, W) int32, segm_soft (H, W, C) float32) host arrays,
        on every rank

    While a profiler records, the call counts ``tiled_calls`` and opens
    ``pyimsegm:upload``, ``prep`` (the whole-image preparation every rank
    repeats), the stage ranges and ``fetch``; every collective opens
    ``pyimsegm:exchange`` inside the stage that calls it.
    """
    from pyimsegm_tpu_torch.ops import color as color_ops
    from pyimsegm_tpu_torch.ops.graphcut import compute_pairwise_cost

    fkey = _fusable_color_spec(_features_spec(dict_features))
    if fkey is None:
        raise ValueError('tiled pipeline supports one color key of moments '
                         '(mean / std / energy) only, got %r'
                         % (dict_features,))
    flags = dict_features[fkey]

    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    count('tiled_calls')
    dev = mesh_device(mesh)
    with stage_range('upload'):
        image = torch.as_tensor(image, device=dev)
    cfg = slic_config(image.shape[0], image.shape[1], sp_size)
    band = _band(cfg, mesh)
    with stage_range('prep'):
        lab_loc, valid_loc, centers0 = _prepare(image, cfg, band,
                                                round_seeds=False)
        img_f = image.to(torch.float32)
        feat_img = (color_ops.convert_img_color_from_rgb(
            img_f, fkey.split('_')[-1]) if '_' in fkey else img_f)
        rows = slice(band.t0 * cfg.step, band.t0 * cfg.step + band.hb)
        feat_loc = _zero_pad(feat_img, cfg)[rows].contiguous()
        del image, img_f, feat_img
        pairwise = torch.as_tensor(
            compute_pairwise_cost(float(gc_regul), nb_classes),
            dtype=torch.float32, device=dev)

    debug = None if debug_visual is None else {}
    segm_loc, soft_loc = _tiled_pipe_shard(
        lab_loc, valid_loc, feat_loc, centers0,
        _spatial_w2(sp_size, sp_regul, cfg), pairwise, band=band,
        n_iter=n_iter, flags=tuple(flags), nb_classes=nb_classes,
        estim_model=estim_model, gc_edge_type=gc_edge_type, seed=seed,
        connectivity=connectivity, debug=debug)
    with stage_range('fetch'):
        segm = _to_host(_gather_rows(segm_loc, mesh, cfg))
        soft = _to_host(_gather_rows(soft_loc, mesh, cfg))
        if debug is not None:
            debug_visual['slic'] = _to_host(_gather_rows(
                debug['labels_loc'], mesh, cfg))
            debug_visual['features'] = debug['features'].cpu().numpy()
            debug_visual['model'] = debug['model']
            debug_visual['proba'] = debug['proba'].cpu().numpy()
    return segm, soft
