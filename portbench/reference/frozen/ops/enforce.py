"""Connectivity enforcement (anchor seed + reach + absorb), frozen from
the twin of the port's ``ops/enforce_cuda``:

1. *Anchor seed*: ``d2`` = squared distance of each pixel to its own
   label's centroid, ``d2min`` its per-superpixel minimum, and
   ``reached0 = d2 <= d2min[label] + 1e-3``.  The per-pixel ``d2min`` comes
   through a one-hot contraction over the tile's 3x3 seeds, so a pixel
   whose tile neighbours an empty superpixel (``d2min`` = inf) reads NaN
   (0 * inf) and is not an anchor.
2. *Reach*: at most ``MAX_SWEEPS`` sweeps; each sweep, along rows then
   columns, marks reached every same-label run that holds a reached pixel.
3. *Absorb*: at most ``2 * step`` rounds; each round, along rows forward and
   back and then columns forward and back, an unreached pixel takes the
   label of its nearest reached pixel when that label lies in its own 3x3
   seed window, and becomes reached.

A converged sweep or round changes nothing, so the early exits give the
capped result exactly.
"""

import torch

from portbench.reference.frozen.ops import grid as grid_ops
from portbench.reference.frozen.ops.grid_passes import grid_lookup, window_code
from portbench.reference.frozen.ops.slic import SlicConfig

#: reach sweep cap
MAX_SWEEPS = 8

_INF = 2 ** 30
_NONE = -2 ** 30


def absorb_rounds(cfg: SlicConfig):
    """Absorb round cap: ``2 * step``."""
    return 2 * cfg.step


def _pack(cfg: SlicConfig):
    """Pack factor of the absorb scans: the smallest power of two above the
    largest label; positions times it must stay inside int32."""
    pack = 1 << int(cfg.n_segments - 1).bit_length()
    if max(cfg.height, cfg.width) * pack >= 2 ** 31:
        raise ValueError('image too large for packed scans')
    return pack


def _lookup_onehot(table, labels, cfg: SlicConfig):
    """(K,) table -> (H, W) by a one-hot contraction over the
    tile's 3x3 seeds: ``sum_o (code == o) * table[seed o]`` with off-grid
    seeds 0, so an inf among the tile's seeds gives NaN (0 * inf)."""
    h, w = labels.shape
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    tgrid = table.to(torch.float32).reshape(gh, gw)
    code = window_code(labels, cfg)
    ty = torch.arange(h, device=labels.device)[:, None] // step
    tx = torch.arange(w, device=labels.device)[None, :] // step
    out = torch.zeros((h, w), dtype=torch.float32, device=labels.device)
    for oi, (di, dj) in enumerate(grid_ops._OFFSETS):
        t9 = grid_ops._shift2d(tgrid, -di, -dj)[ty, tx]   # seed (ty+di, tx+dj)
        out = out + (code == oi).to(torch.float32) * t9
    return out


def anchor_seed(labels, centers, cfg: SlicConfig):
    """The reached plane (H, W) bool of step 1 above.

    :param labels: (H, W) int32 grid-structured SLIC labels
    :param centers: (K, 2) f32 centroids in (y, x)
    """
    h, w = labels.shape
    py = torch.arange(h, dtype=torch.float32, device=labels.device)[:, None]
    px = torch.arange(w, dtype=torch.float32, device=labels.device)[None, :]
    cpix = grid_lookup(centers.to(torch.float32), labels, cfg)
    dy = py - cpix[..., 0]
    dx = px - cpix[..., 1]
    d2 = dy * dy + dx * dx
    d2min = grid_ops.grid_segment_min(d2, labels, cfg)
    return d2 <= _lookup_onehot(d2min, labels, cfg) + 1e-3


def _cummax(x, dim, reverse=False):
    if reverse:
        return torch.cummax(x.flip(dim), dim)[0].flip(dim)
    return torch.cummax(x, dim)[0]


def _cummin(x, dim, reverse=False):
    if reverse:
        return torch.cummin(x.flip(dim), dim)[0].flip(dim)
    return torch.cummin(x, dim)[0]


def connect_components(labels, reached0, cfg: SlicConfig):
    """Reach: run-constrained scan sweeps, at most ``MAX_SWEEPS``; then
    :func:`_absorb_unreached`."""
    h, w = labels.shape
    lab = labels.to(torch.int64)
    rowi = torch.arange(h, device=labels.device)[:, None].expand(h, w)
    coli = torch.arange(w, device=labels.device)[None, :].expand(h, w)

    def run_edges(axis, idx):
        lo = (1, 0) if axis == 0 else (0, 1)
        hi = (-1, 0) if axis == 0 else (0, -1)
        chg_lo = lab != grid_ops._shift2d(lab, *lo, -9)
        chg_hi = lab != grid_ops._shift2d(lab, *hi, -9)
        start = _cummax(torch.where(chg_lo, idx, -_INF), axis)
        end = _cummin(torch.where(chg_hi, idx, _INF), axis, reverse=True)
        return start, end

    rs, re = run_edges(1, coli)
    cs, ce = run_edges(0, rowi)

    def sweep(r):
        r = r | (_cummax(torch.where(r, coli, -_INF), 1) >= rs)
        r = r | (_cummin(torch.where(r, coli, _INF), 1, reverse=True) <= re)
        r = r | (_cummax(torch.where(r, rowi, -_INF), 0) >= cs)
        r = r | (_cummin(torch.where(r, rowi, _INF), 0, reverse=True) <= ce)
        return r

    reached = sweep(reached0)
    for _ in range(MAX_SWEEPS - 1):
        new = sweep(reached)
        if torch.equal(new, reached):
            break
        reached = new
    return _absorb_unreached(labels, reached, cfg)


def _absorb_unreached(labels, reached, cfg: SlicConfig):
    """Relabel unreached pixels to their nearest reached donor label along
    rows and columns, within the 3x3 seed window; at most ``2 * step``
    rounds."""
    h, w = labels.shape
    gw, step = cfg.grid_w, cfg.step
    lab = labels.to(torch.int64)
    rowi = torch.arange(h, device=labels.device)[:, None].expand(h, w)
    coli = torch.arange(w, device=labels.device)[None, :].expand(h, w)
    ty, tx = rowi // step, coli // step
    pack = _pack(cfg)

    def absorb_pass(lab, reached, axis, reverse, idx):
        # idx is +position forward (nearest donor behind = max) or
        # -position in reverse (nearest donor ahead = max of the negated);
        # the floor-mod recovers the label from either sign
        packed = torch.where(reached, idx * pack + lab, _NONE)
        near = _cummax(packed, axis, reverse)
        dl = torch.remainder(near, pack)
        ok = (near > _NONE // 2) & ~reached \
            & ((dl // gw - ty).abs() <= 1) & ((dl % gw - tx).abs() <= 1)
        return torch.where(ok, dl, lab), reached | ok

    for _ in range(absorb_rounds(cfg)):
        r0 = reached
        lab, reached = absorb_pass(lab, reached, 1, False, coli)
        lab, reached = absorb_pass(lab, reached, 1, True, -coli)
        lab, reached = absorb_pass(lab, reached, 0, False, rowi)
        lab, reached = absorb_pass(lab, reached, 0, True, -rowi)
        if torch.equal(reached, r0):
            break
    return lab.to(torch.int32)
