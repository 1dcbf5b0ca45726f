"""The pixel passes over grid-structured SLIC labels (frozen from the
twins of the port's ``ops/grid_cuda``): per-superpixel sums, the lookup,
the conn4 adjacency and pair counts each routed to the seeds, and the
geometry + moments reduce.  Every SLIC label is one of the 3x3 seeds
around its pixel's tile, so each pass is a masked tile sum per offset,
routed to its seed by a grid shift.
"""

import torch

from portbench.reference.frozen.ops.slic import SlicConfig


def _tile_index(h, w, step, device):
    ty = torch.arange(h, device=device)[:, None] // step
    tx = torch.arange(w, device=device)[None, :] // step
    return ty, tx


def window_code(labels, cfg: SlicConfig):
    """Offset code 0..8 of each pixel's label within its tile's 3x3 seed
    window, -1 where the label is negative or outside the window.  A label
    beyond K that falls in the window keeps its code (its sums route off
    the grid)."""
    h, w = labels.shape
    ty, tx = _tile_index(h, w, cfg.step, labels.device)
    lab = labels.to(torch.int64)
    ok = lab >= 0
    safe = torch.where(ok, lab, 0)
    dy = safe // cfg.grid_w - ty + 1
    dx = safe % cfg.grid_w - tx + 1
    ok = ok & (dy >= 0) & (dy < 3) & (dx >= 0) & (dx < 3)
    return torch.where(ok, dy * 3 + dx, -1)


def grid_reduce(data, labels, cfg: SlicConfig):
    """(K, F) f32 per-superpixel sums of (H, W, F) data: per-offset masked
    tile sums routed to their seeds by 9 grid shifts."""
    from portbench.reference.frozen.ops.grid import _OFFSETS, _pad_to_grid, _shift2d
    f = data.shape[-1]
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    data_p = _pad_to_grid(data.to(torch.float32), cfg)
    code = window_code(_pad_to_grid(labels, cfg, fill=-2), cfg)
    out = torch.zeros((gh, gw, f), dtype=torch.float32, device=data.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        w = (code == idx).to(torch.float32)[..., None]
        part = (data_p * w).reshape(gh, step, gw, step, f).sum(dim=(1, 3))
        out = out + _shift2d(part, di, dj)
    return out.reshape(gh * gw, f)


def grid_lookup(table, labels, cfg: SlicConfig):
    """Per-pixel ``table[labels]`` of a (K,) or (K, C) float32 or int32
    table: 0 where a label is negative, not below K or outside its pixel's
    3x3 seed window.

    :returns: (H, W) or (H, W, C) of ``table.dtype``
    """
    flat = table.reshape(cfg.n_segments, -1)
    ok = (window_code(labels, cfg) >= 0) & (labels < cfg.n_segments)
    idx = torch.where(ok, labels.to(torch.int64), 0)
    out = torch.where(ok[..., None], flat[idx], 0.0)
    return out.to(table.dtype).reshape(labels.shape + table.shape[1:])


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


def adjacency_presence(labels, cfg: SlicConfig):
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
    code = window_code(labels, cfg)
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


def _sym_mask_adjacency(adj, gh, gw):
    """Raw pair channels -> symmetric 0/1 adjacency with out-of-range and
    self channels zeroed."""
    from portbench.reference.frozen.ops.grid import (_SELF, GRAPH_OFFSETS,
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


def grid_adjacency(labels, cfg: SlicConfig):
    """(gh, gw, 25) 0/1 f32 adjacency between each superpixel and its grid
    neighbours from conn4 pixel pairs: the presence words, routed to their
    seeds by 9 grid shifts, symmetric, with off-grid and self channels
    zeroed."""
    from portbench.reference.frozen.ops.grid import _OFFSETS, _shift2d
    gh, gw = cfg.grid_h, cfg.grid_w
    words = adjacency_presence(labels, cfg)         # (gh, gw, 9)
    ch = torch.arange(25, device=words.device, dtype=torch.int32)
    bits = ((words[..., None] >> ch) & 1).to(torch.float32)     # (.., 9, 25)
    adj = torch.zeros((gh, gw, 25), dtype=torch.float32, device=words.device)
    for idx, (di, dj) in enumerate(_OFFSETS):
        adj = adj + _shift2d(bits[:, :, idx], di, dj)
    return _sym_mask_adjacency(adj, gh, gw)


def _pair_channel(a, b, gw):
    """Relative seed channel (dy + 2) * 5 + dx + 2 of a conn4 pair (a, b) of
    distinct labels within +-2 grid cells, else -1."""
    ok = (a >= 0) & (b >= 0) & (a != b)
    sa, sb = torch.where(ok, a, 0), torch.where(ok, b, 0)
    dy = sb // gw - sa // gw
    dx = sb % gw - sa % gw
    ok = ok & (dy.abs() <= 2) & (dx.abs() <= 2)
    return torch.where(ok, (dy + 2) * 5 + (dx + 2), -1)


def grid_pair_count(labels, cfg: SlicConfig):
    """(cnt9 (gh, gw, 9, 25) f32, counts9 (gh, gw, 9) f32): directed conn4
    boundary-pair counts of each tile's pixels grouped by the routing offset
    of the first endpoint's label, and the tile's pixel counts per offset."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    h, w = labels.shape
    a = labels.to(torch.int64)
    minus2 = torch.full_like(a, -2)
    right = torch.cat([a[:, 1:], minus2[:, :1]], dim=1)
    down = torch.cat([a[1:], minus2[:1]], dim=0)
    code = window_code(labels, cfg)
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


def counts_and_contacts(labels, cfg: SlicConfig):
    """Per-superpixel pixel counts, symmetric boundary-contact counts and
    the per-(tile, offset) pixel counts, the measurement behind the
    min-size merge.

    :returns: (counts (K,) f32, sym25 (gh, gw, 25) f32, counts9 (gh, gw, 9)
        f32) -- exact integers
    """
    from portbench.reference.frozen.ops.grid import sym_contact_counts
    from portbench.reference.frozen.ops.slic_passes import combine_sums
    gh, gw = cfg.grid_h, cfg.grid_w
    cnt9, counts9 = grid_pair_count(labels, cfg)
    counts = combine_sums(counts9[..., None])[..., 0]
    return (counts.reshape(gh * gw),
            sym_contact_counts(combine_sums(cnt9), gh, gw), counts9)


def _route_moments(partials):
    """(gh, gw, 9, CH) per-(tile, offset) partials -> (K, CH) per-seed sums,
    offsets added in order."""
    from portbench.reference.frozen.ops.slic_passes import combine_sums
    gh, gw, _, ch = partials.shape
    return combine_sums(partials).reshape(gh * gw, ch)


def grid_moments(feat, labels, cfg: SlicConfig):
    """Per-(tile, offset) masked sums of [f, f^2, 1, y, x] over the labels,
    routed to their seeds.

    :param feat: (H, W, F) float feature image
    :returns: (K, 2F+3) f32 = [sum f, sum f^2, count, sum y, sum x]
    """
    from portbench.reference.frozen.ops.grid import _pad_to_grid
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    h, w = labels.shape
    feat = feat.to(torch.float32)
    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=feat.device),
        torch.arange(w, dtype=torch.float32, device=feat.device),
        indexing='ij')
    data = torch.cat([feat, feat * feat, torch.ones_like(py)[..., None],
                      py[..., None], px[..., None]], dim=-1)
    nch = data.shape[-1]
    data_p = _pad_to_grid(data, cfg)
    code = window_code(_pad_to_grid(labels, cfg, fill=-2), cfg)
    parts = [(data_p * (code == oi).to(torch.float32)[..., None])
             .reshape(gh, step, gw, step, nch).sum(dim=(1, 3))
             for oi in range(9)]
    return _route_moments(torch.stack(parts, dim=2))
