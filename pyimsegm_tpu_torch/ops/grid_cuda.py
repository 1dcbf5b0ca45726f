"""Grid lookup, conn4 adjacency, conn4 pair counts, the moments reduce
with the min-size donor apply and the generic per-superpixel sum: CUDA
kernels and twins.

Replaces five kernels of ``pyimsegm_tpu.ops.grid_pallas`` with the kernels
of ``csrc/grid.cu``: ``grid_reduce_pallas``, ``grid_lookup_pallas``,
``grid_adjacency_presence_pallas`` (also with the routing and symmetrising
of ``grid_adjacency`` in the same C call), ``grid_pair_count_pallas`` (also
with the routing of ``counts_and_contacts`` in the same C call) and
``grid_moments_apply_pallas``, whose donor-less mode also replaces
``grid_moments_pallas``.  Each wrapper launches its kernel for CUDA tensors
and runs its plain twin for CPU tensors; every kernel takes any seed step.
"""

import functools
import math

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic import SlicConfig

#: kernel launches in this process, per wrapper
LAUNCHES = {'grid_reduce': 0, 'grid_lookup': 0, 'grid_adjacency_presence': 0,
            'grid_pair_count': 0, 'grid_moments_apply': 0, 'grid_moments': 0}
#: the launches of rows 6 and 7 counted by F (and dtype for row 6), beside
#: their counts in LAUNCHES: {'grid_reduce F=7 float32': n, 'grid_moments
#: F=60': n, ...}
LAUNCHES_BY_F = {}


@functools.cache
def _lib():
    v, i = _build.VOIDP, _build.INT
    return _build.load('grid', {
        'grid_reduce': [v] * 4 + [i] * 7 + [v],
        'grid_lookup': [v, v, v] + [i] * 6 + [v],
        'grid_adjacency': [v] * 3 + [i] * 5 + [v],
        'grid_pair_count': [v] * 5 + [i] * 5 + [v],
        'grid_moments_apply': [v] * 6 + [i] * 6 + [v],
        'grid_moments': [v] * 4 + [i] * 6 + [v],
    })


def _count_by_f(key):
    LAUNCHES_BY_F[key] = LAUNCHES_BY_F.get(key, 0) + 1


def _tile_index(h, w, step, device):
    ty = torch.arange(h, device=device)[:, None] // step
    tx = torch.arange(w, device=device)[None, :] // step
    return ty, tx


def _window_code(labels, cfg: SlicConfig):
    """Offset code 0..8 of each pixel's label within its tile's 3x3 seed
    window, -1 where the label is negative or outside the window.  As in the
    Pallas kernels, a label beyond K that falls in the window keeps its code
    (its sums route off the grid)."""
    h, w = labels.shape
    ty, tx = _tile_index(h, w, cfg.step, labels.device)
    lab = labels.to(torch.int64)
    ok = lab >= 0
    safe = torch.where(ok, lab, 0)
    dy = safe // cfg.grid_w - ty + 1
    dx = safe % cfg.grid_w - tx + 1
    ok = ok & (dy >= 0) & (dy < 3) & (dx >= 0) & (dx < 3)
    return torch.where(ok, dy * 3 + dx, -1)


def _grid_reduce_plain(data, labels, cfg: SlicConfig):
    """(K, F) f32 per-superpixel sums of (H, W, F) data: per-offset masked
    tile sums routed to their seeds by 9 grid shifts."""
    from pyimsegm_tpu_torch.ops.grid import _OFFSETS, _pad_to_grid, _shift2d
    f = data.shape[-1]
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    data_p = _pad_to_grid(data.to(torch.float32), cfg)
    code = _window_code(_pad_to_grid(labels, cfg, fill=-2), cfg)
    out = torch.zeros((gh, gw, f), dtype=torch.float32, device=data.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        w = (code == idx).to(torch.float32)[..., None]
        part = (data_p * w).reshape(gh, step, gw, step, f).sum(dim=(1, 3))
        out = out + _shift2d(part, di, dj)
    return out.reshape(gh * gw, f)


def grid_reduce(data, labels, cfg: SlicConfig):
    """Per-superpixel sums of (H, W, F) data over grid-structured labels.

    :param data: (H, W, F) float tensor; bf16 is read as bf16 (f32 sums),
        every other dtype goes through f32
    :param labels: (H, W) int32; a pixel whose label is negative or outside
        its tile's 3x3 seed window adds nothing
    :returns: (K, F) f32 sums
    """
    if not labels.is_cuda:
        return _grid_reduce_plain(data, labels, cfg)
    h, w, f = data.shape
    if data.dtype != torch.bfloat16:
        data = data.to(torch.float32)
    data = _build.require(data.contiguous(), 'data', data.dtype,
                          (cfg.height, cfg.width, f))
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    dev = labels.device
    partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, f), dtype=torch.float32,
                           device=dev)
    out = torch.empty((cfg.n_segments, f), dtype=torch.float32, device=dev)
    _build.launch(_lib().grid_reduce, 'grid_reduce', labels,
                  data.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                  out.data_ptr(), h, w, f, cfg.grid_h, cfg.grid_w, cfg.step,
                  int(data.dtype == torch.bfloat16))
    LAUNCHES['grid_reduce'] += 1
    _count_by_f('grid_reduce F=%d %s' % (f, str(data.dtype).split('.')[-1]))
    return out


def _grid_lookup_plain(table, labels, cfg: SlicConfig):
    """(K, C) f32 table, (H, W) labels -> (H, W, C): ``table[label]`` where
    the label lies in its pixel's 3x3 seed window, else 0."""
    ok = (_window_code(labels, cfg) >= 0) & (labels < cfg.n_segments)
    idx = torch.where(ok, labels.to(torch.int64), 0)
    return torch.where(ok[..., None], table[idx], 0.0)


def grid_lookup(table, labels, cfg: SlicConfig):
    """Per-pixel ``table[labels]`` for grid-structured labels.

    :param table: (K,) or (K, C) float32 or int32; the kernel copies its
        words as they are
    :param labels: (H, W) int32
    :returns: (H, W) or (H, W, C) of ``table.dtype``; 0 where a label is
        negative, not below K or outside its pixel's 3x3 seed window
    """
    if table.dtype not in (torch.float32, torch.int32) or table.ndim > 2 \
            or table.shape[0] != cfg.n_segments:
        raise ValueError('table must be (K,) or (K, C) float32 or int32, got '
                         '%s %s' % (tuple(table.shape), table.dtype))
    if not labels.is_cuda:
        out = _grid_lookup_plain(table.reshape(cfg.n_segments, -1), labels,
                                 cfg)
        return out.to(table.dtype).reshape(labels.shape + table.shape[1:])
    h, w = labels.shape
    table = _build.require(table.contiguous(), 'table', table.dtype)
    labels = _build.require(labels.contiguous(), 'labels', torch.int32)
    out = labels.new_empty(labels.shape + table.shape[1:], dtype=table.dtype)
    _build.launch(_lib().grid_lookup, 'grid_lookup', labels,
                  table.data_ptr(), labels.data_ptr(), out.data_ptr(), h, w,
                  table.numel() // cfg.n_segments, cfg.grid_h, cfg.grid_w,
                  cfg.step)
    LAUNCHES['grid_lookup'] += 1
    return out


def _pair_bits(a, b, gw):
    """``1 << ch`` for a conn4 pair (a, b) of distinct labels within +-2 grid
    cells (ch = (dy + 2) * 5 + dx + 2), else 0."""
    ok = (a >= 0) & (b >= 0) & (a != b)
    sa, sb = torch.where(ok, a, 0), torch.where(ok, b, 0)
    dy = sb // gw - sa // gw
    dx = sb % gw - sa % gw
    ok = ok & (dy.abs() <= 2) & (dx.abs() <= 2)
    ch = torch.where(ok, (dy + 2) * 5 + (dx + 2), 0)
    return torch.where(ok, torch.ones_like(ch) << ch, 0)


def _grid_adjacency_presence_plain(labels, cfg: SlicConfig):
    """(gh, gw, 9) int32 words: bit ch of word [ty, tx, o] is set when a
    pixel of tile (ty, tx) whose label sits at offset o of the tile window
    has a right or down neighbour at relative seed offset ch."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    h, w = labels.shape
    a = labels.to(torch.int64)
    minus2 = torch.full_like(a, -2)
    right = torch.cat([a[:, 1:], minus2[:, :1]], dim=1)
    down = torch.cat([a[1:], minus2[:1]], dim=0)
    bits = _pair_bits(a, right, gw) | _pair_bits(a, down, gw)   # (H, W)
    code = _window_code(labels, cfg)
    ty, tx = _tile_index(h, w, step, labels.device)
    tile = (ty * gw + tx).expand(h, w)
    ch = torch.arange(25, device=labels.device)
    present = ((bits[..., None] >> ch) & 1).bool() & (code >= 0)[..., None]
    flat = torch.zeros(gh * gw * 9 * 25, dtype=torch.int64,
                       device=labels.device)
    key = ((tile * 9 + code.clamp_min(0))[..., None] * 25 + ch)[present]
    flat[key] = 1
    words = (flat.reshape(gh, gw, 9, 25) << ch).sum(dim=-1)
    return words.to(torch.int32)


def _adjacency_launch(labels, cfg: SlicConfig, routed):
    """Row 11 on the card: the (gh, gw, 9) int32 presence words, and with
    ``routed`` also the (gh, gw, 25) f32 adjacency, from one C call into
    one allocation."""
    h, w = labels.shape
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    gh, gw = cfg.grid_h, cfg.grid_w
    n9 = gh * gw * 9
    buf = torch.empty((n9 + (gh * gw * 25 if routed else 0),),
                      dtype=torch.int32, device=labels.device)
    words = buf[:n9].view(gh, gw, 9)
    adj = buf[n9:].view(torch.float32).view(gh, gw, 25) if routed else None
    _build.launch(_lib().grid_adjacency, 'grid_adjacency_presence', labels,
                  labels.data_ptr(), words.data_ptr(),
                  adj.data_ptr() if routed else None, h, w, gh, gw, cfg.step)
    LAUNCHES['grid_adjacency_presence'] += 1
    return words, adj


def grid_adjacency_presence(labels, cfg: SlicConfig):
    """Conn4 superpixel adjacency presence as (gh, gw, 9) 25-bit words,
    grouped by the routing offset of the first endpoint.

    :param labels: (H, W) int32 grid-structured labels
    """
    if not labels.is_cuda:
        return _grid_adjacency_presence_plain(labels, cfg)
    return _adjacency_launch(labels, cfg, routed=False)[0]


def _sym_mask_adjacency(adj, gh, gw):
    """Raw pair channels -> symmetric 0/1 adjacency with out-of-range and
    self channels zeroed."""
    from pyimsegm_tpu_torch.ops.grid import (_SELF, GRAPH_OFFSETS,
                                             _flip_channel_perm, _shift2d)
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


def _grid_adjacency_plain(labels, cfg: SlicConfig):
    """Twin of the routed adjacency: the presence words, routed to their
    seeds by 9 grid shifts, then symmetrised and masked in PyTorch."""
    from pyimsegm_tpu_torch.ops.grid import _OFFSETS, _shift2d
    gh, gw = cfg.grid_h, cfg.grid_w
    words = _grid_adjacency_presence_plain(labels, cfg)         # (gh, gw, 9)
    ch = torch.arange(25, device=words.device, dtype=torch.int32)
    bits = ((words[..., None] >> ch) & 1).to(torch.float32)     # (.., 9, 25)
    adj = torch.zeros((gh, gw, 25), dtype=torch.float32, device=words.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        adj = adj + _shift2d(bits[:, :, idx], di, dj)
    return _sym_mask_adjacency(adj, gh, gw)


def grid_adjacency(labels, cfg: SlicConfig):
    """Row 11 with its route: the (gh, gw, 25) 0/1 f32 adjacency between
    each superpixel and its grid neighbours from conn4 pixel pairs,
    symmetric, with off-grid and self channels zeroed; two CUDA kernels on
    the card.

    :param labels: (H, W) int32 grid-structured labels
    """
    if not labels.is_cuda:
        return _grid_adjacency_plain(labels, cfg)
    return _adjacency_launch(labels, cfg, routed=True)[1]


def _pair_channel(a, b, gw):
    """Relative seed channel (dy + 2) * 5 + dx + 2 of a conn4 pair (a, b) of
    distinct labels within +-2 grid cells, else -1."""
    ok = (a >= 0) & (b >= 0) & (a != b)
    sa, sb = torch.where(ok, a, 0), torch.where(ok, b, 0)
    dy = sb // gw - sa // gw
    dx = sb % gw - sa % gw
    ok = ok & (dy.abs() <= 2) & (dx.abs() <= 2)
    return torch.where(ok, (dy + 2) * 5 + (dx + 2), -1)


def _grid_pair_count_plain(labels, cfg: SlicConfig):
    """(cnt9 (gh, gw, 9, 25) f32, counts9 (gh, gw, 9) f32): directed conn4
    boundary-pair counts of each tile's pixels grouped by the routing offset
    of the first endpoint's label, and the tile's pixel counts per offset."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    h, w = labels.shape
    a = labels.to(torch.int64)
    minus2 = torch.full_like(a, -2)
    right = torch.cat([a[:, 1:], minus2[:, :1]], dim=1)
    down = torch.cat([a[1:], minus2[:1]], dim=0)
    code = _window_code(labels, cfg)
    ty, tx = _tile_index(h, w, step, labels.device)
    slot = (ty * gw + tx) * 9 + code                            # (H, W)
    valid = code >= 0
    counts9 = torch.bincount(slot[valid], minlength=gh * gw * 9)
    cnt9 = torch.zeros(gh * gw * 9 * 25, dtype=torch.int64,
                       device=labels.device)
    for b in (right, down):
        ch = _pair_channel(a, b, gw)
        keep = valid & (ch >= 0)
        cnt9 += torch.bincount((slot * 25 + ch)[keep],
                               minlength=gh * gw * 9 * 25)
    return (cnt9.reshape(gh, gw, 9, 25).to(torch.float32),
            counts9.reshape(gh, gw, 9).to(torch.float32))


def _pair_count_launch(labels, cfg: SlicConfig, routed):
    """Row 10 on the card: (cnt9, counts9), and with ``routed`` also the
    routed (counts, sym25), from one C call into one allocation."""
    h, w = labels.shape
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    gh, gw, k = cfg.grid_h, cfg.grid_w, cfg.n_segments
    shapes = [(gh, gw, 9, 25), (gh, gw, 9)] + ([(k,), (gh, gw, 25)]
                                               if routed else [])
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=labels.device)
    out = [part.view(shape)
           for part, shape in zip(torch.split(buf, sizes), shapes)]
    ptrs = [t.data_ptr() for t in out] + [None] * (4 - len(out))
    _build.launch(_lib().grid_pair_count, 'grid_pair_count', labels,
                  labels.data_ptr(), *ptrs, h, w, gh, gw, cfg.step)
    LAUNCHES['grid_pair_count'] += 1
    return out


def grid_pair_count(labels, cfg: SlicConfig):
    """Conn4 boundary-pair counts and pixel counts in one pass.

    :param labels: (H, W) int32 grid-structured labels
    :returns: (cnt9 (gh, gw, 9, 25) f32 directed pair counts grouped by the
        first endpoint's routing offset, channel ``(dy+2)*5 + dx+2`` of the
        second endpoint; counts9 (gh, gw, 9) f32 pixel counts per tile and
        offset) -- exact integers
    """
    if not labels.is_cuda:
        return _grid_pair_count_plain(labels, cfg)
    return tuple(_pair_count_launch(labels, cfg, routed=False))


def _counts_and_contacts_plain(labels, cfg: SlicConfig):
    """Twin of the routed pair count: the pass, then ``combine_sums`` and
    ``sym_contact_counts`` in PyTorch."""
    from pyimsegm_tpu_torch.ops.grid import sym_contact_counts
    from pyimsegm_tpu_torch.ops.slic_cuda import combine_sums
    gh, gw = cfg.grid_h, cfg.grid_w
    cnt9, counts9 = _grid_pair_count_plain(labels, cfg)
    counts = combine_sums(counts9[..., None])[..., 0]
    return (counts.reshape(gh * gw),
            sym_contact_counts(combine_sums(cnt9), gh, gw), counts9)


def counts_and_contacts(labels, cfg: SlicConfig):
    """Row 10 with its route: per-superpixel pixel counts, symmetric
    boundary-contact counts and the per-(tile, offset) pixel counts, the
    measurement behind the min-size merge; two CUDA kernels on the card.

    :param labels: (H, W) int32 grid-structured labels
    :returns: (counts (K,) f32, sym25 (gh, gw, 25) f32, counts9 (gh, gw, 9)
        f32) -- exact integers
    """
    if not labels.is_cuda:
        return _counts_and_contacts_plain(labels, cfg)
    _, counts9, counts, sym25 = _pair_count_launch(labels, cfg, routed=True)
    return counts, sym25, counts9


def _route_moments(partials):
    """(gh, gw, 9, CH) per-(tile, offset) partials -> (K, CH) per-seed sums,
    offsets added in order."""
    from pyimsegm_tpu_torch.ops.slic_cuda import combine_sums
    gh, gw, _, ch = partials.shape
    return combine_sums(partials).reshape(gh * gw, ch)


def _apply_donor(labels, donor, cfg: SlicConfig):
    """Merged labels: ``donor[label]`` where the label lies in its pixel's
    3x3 seed window and on the grid and the donor seed lies in that window
    too; every other pixel keeps its label."""
    h, w = labels.shape
    gw = cfg.grid_w
    lab = labels.to(torch.int64)
    ok = (_window_code(labels, cfg) >= 0) & (lab < cfg.n_segments)
    new = torch.where(ok, donor.to(torch.int64)[torch.where(ok, lab, 0)], -1)
    ty, tx = _tile_index(h, w, cfg.step, labels.device)
    ok = (new >= 0) & ((new // gw - ty).abs() <= 1) \
        & ((new % gw - tx).abs() <= 1)
    return torch.where(ok, new, lab).to(torch.int32)


def _grid_moments_apply_plain(feat, labels, donor, cfg: SlicConfig):
    """Donor apply (when ``donor`` is given), then per-(tile, offset) masked
    sums of [f, f^2, 1, y, x] over the merged labels routed to their seeds."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    h, w = labels.shape
    merged = labels if donor is None else _apply_donor(labels, donor, cfg)
    feat = feat.to(torch.float32)
    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=feat.device),
        torch.arange(w, dtype=torch.float32, device=feat.device),
        indexing='ij')
    data = torch.cat([feat, feat * feat, torch.ones_like(py)[..., None],
                      py[..., None], px[..., None]], dim=-1)
    nch = data.shape[-1]
    from pyimsegm_tpu_torch.ops.grid import _pad_to_grid
    data_p = _pad_to_grid(data, cfg)
    code = _window_code(_pad_to_grid(merged, cfg, fill=-2), cfg)
    parts = [(data_p * (code == oi).to(torch.float32)[..., None])
             .reshape(gh, step, gw, step, nch).sum(dim=(1, 3))
             for oi in range(9)]
    return merged, _route_moments(torch.stack(parts, dim=2))


def grid_moments_apply(feat, labels, donor, cfg: SlicConfig):
    """Apply a min-size donor table and reduce geometry + moments over the
    merged labels in one pass; with ``donor=None`` only the reduce (the
    replacement of ``grid_moments_pallas``).

    On the card the donor apply (row 8, ``grid_moments_apply_pallas``) takes
    F = 3, the colour image of the fused branch, its only caller; the
    donor-less reduce (row 7) takes any F >= 1, as the texture batteries
    need (F = 18 or 60).

    :param feat: (H, W, F) float feature image
    :param labels: (H, W) int32 enforced (pre-merge) labels
    :param donor: (K,) integer merge targets, or None
    :returns: (merged labels (H, W) int32, sums (K, 2F+3) f32 =
        [sum f, sum f^2, count, sum y, sum x])
    """
    if not labels.is_cuda:
        return _grid_moments_apply_plain(feat, labels, donor, cfg)
    h, w = labels.shape
    f = feat.shape[-1]
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    feat = _build.require(feat.to(torch.float32).contiguous(), 'feat',
                          torch.float32, (h, w, 3 if donor is not None else f))
    dev = labels.device
    if donor is None:
        if f < 1:
            raise ValueError('feat must have at least one channel')
        nch = 2 * f + 3
        partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, nch),
                               dtype=torch.float32, device=dev)
        out = torch.empty((cfg.n_segments, nch), dtype=torch.float32,
                          device=dev)
        _build.launch(_lib().grid_moments, 'grid_moments', labels,
                      feat.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                      out.data_ptr(), h, w, f, cfg.grid_h, cfg.grid_w,
                      cfg.step)
        LAUNCHES['grid_moments'] += 1
        _count_by_f('grid_moments F=%d' % f)
        return labels, out
    if donor.dtype != torch.int64:
        donor = donor.to(torch.int32)
    donor = _build.require(donor.contiguous(), 'donor', donor.dtype,
                           (cfg.n_segments,))
    merged = torch.empty_like(labels)
    partials = labels.new_empty((cfg.grid_h, cfg.grid_w, 9, 9),
                                dtype=torch.float32)
    out = labels.new_empty((cfg.n_segments, 9), dtype=torch.float32)
    _build.launch(_lib().grid_moments_apply, 'grid_moments_apply', labels,
                  feat.data_ptr(), labels.data_ptr(), donor.data_ptr(),
                  merged.data_ptr(), partials.data_ptr(), out.data_ptr(), h,
                  w, cfg.grid_h, cfg.grid_w, cfg.step,
                  int(donor.dtype == torch.int64))
    LAUNCHES['grid_moments_apply'] += 1
    return merged, out
