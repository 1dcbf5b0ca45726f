"""Grid lookup and conn4 adjacency presence: CUDA kernels and twins.

Replaces ``pyimsegm_tpu.ops.grid_pallas.grid_lookup_pallas`` and
``grid_adjacency_presence_pallas`` with the kernels of ``csrc/grid.cu``.
Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors.
"""

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic import SlicConfig

#: kernel launches in this process, per wrapper
LAUNCHES = {'grid_lookup': 0, 'grid_adjacency_presence': 0}


def _lib():
    v, i = _build.VOIDP, _build.INT
    return _build.load('grid', {
        'grid_lookup': [v, v, v] + [i] * 6 + [v],
        'grid_adjacency_presence': [v, v] + [i] * 5 + [v],
    })


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


def _grid_lookup_plain(table, labels, cfg: SlicConfig):
    """(K, C) f32 table, (H, W) labels -> (H, W, C): ``table[label]`` where
    the label lies in its pixel's 3x3 seed window, else 0."""
    ok = (_window_code(labels, cfg) >= 0) & (labels < cfg.n_segments)
    idx = torch.where(ok, labels.to(torch.int64), 0)
    return torch.where(ok[..., None], table[idx], 0.0)


def grid_lookup(table, labels, cfg: SlicConfig):
    """Per-pixel ``table[labels]`` for grid-structured labels.

    :param table: (K, C) float32
    :param labels: (H, W) int32
    :returns: (H, W, C) float32; 0 where a label is negative or outside its
        pixel's 3x3 seed window
    """
    if not labels.is_cuda:
        return _grid_lookup_plain(table, labels, cfg)
    h, w = labels.shape
    c = table.shape[-1]
    table = _build.require(table.contiguous(), 'table', torch.float32,
                           (cfg.n_segments, c))
    labels = _build.require(labels.contiguous(), 'labels', torch.int32)
    out = torch.empty((h, w, c), dtype=torch.float32, device=labels.device)
    with torch.cuda.device(labels.device):
        err = _lib().grid_lookup(table.data_ptr(), labels.data_ptr(),
                                 out.data_ptr(), h, w, c, cfg.grid_h,
                                 cfg.grid_w, cfg.step,
                                 _build.stream_ptr(labels))
    _build.check(err, 'grid_lookup')
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


def grid_adjacency_presence(labels, cfg: SlicConfig):
    """Conn4 superpixel adjacency presence as (gh, gw, 9) 25-bit words,
    grouped by the routing offset of the first endpoint.

    :param labels: (H, W) int32 grid-structured labels
    """
    if not labels.is_cuda:
        return _grid_adjacency_presence_plain(labels, cfg)
    h, w = labels.shape
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    words = torch.empty((cfg.grid_h, cfg.grid_w, 9), dtype=torch.int32,
                        device=labels.device)
    with torch.cuda.device(labels.device):
        err = _lib().grid_adjacency_presence(
            labels.data_ptr(), words.data_ptr(), h, w, cfg.grid_h, cfg.grid_w,
            cfg.step, _build.stream_ptr(labels))
    _build.check(err, 'grid_adjacency_presence')
    LAUNCHES['grid_adjacency_presence'] += 1
    return words
