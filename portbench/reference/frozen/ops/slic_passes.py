"""The passes of 2D SLIC on the seed grid (frozen from the twins of the
port's ``ops/slic_cuda``): each pixel takes the first best of its 9
candidate seeds (row-major ``(di, dj)`` order) under
``d = dc2 + (ds2 * sw) * m2``; per-(tile, offset) partial sums
[L, a, b, y, x, count] are routed to their seeds in :func:`combine_sums`'s
order, divided, and an empty cluster keeps its centre.
"""

import torch

from portbench.reference.frozen.ops.grid import _shift2d
from portbench.reference.frozen.ops.slic import (
    SlicConfig, _upsample_grid, slic_weights)

OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def combine_sums(partials):
    """Shift per-offset partials to their target seed and sum.

    :param partials: (gh, gw, 9, CH)
    :returns: (gh, gw, CH) per-seed sums, offsets added in order
    """
    sums = torch.zeros(partials.shape[:2] + partials.shape[3:],
                       dtype=torch.float32, device=partials.device)
    for oi, (di, dj) in enumerate(OFFSETS):
        sums = sums + _shift2d(partials[:, :, oi], di, dj)
    return sums


def assign(lab_p, centers, sw, m2, cfg: SlicConfig):
    """First-best of the 9 candidate seeds per pixel.

    :param lab_p: (3, pad_h, pad_w) Lab planes (bf16 ok)
    :param centers: (gh, gw, 5) f32
    :returns: (labels (pad_h, pad_w) int32, winning offset (pad_h, pad_w))
    """
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = centers.device
    lab = lab_p.to(torch.float32)
    py = torch.arange(cfg.pad_h, dtype=torch.float32, device=dev)[:, None]
    px = torch.arange(cfg.pad_w, dtype=torch.float32, device=dev)[None, :]
    ty = torch.arange(gh, device=dev)[:, None]
    tx = torch.arange(gw, device=dev)[None, :]
    best_d = torch.full((cfg.pad_h, cfg.pad_w), 1e10, dtype=torch.float32,
                        device=dev)
    best_o = torch.zeros((cfg.pad_h, cfg.pad_w), dtype=torch.int64, device=dev)
    for oi, (di, dj) in enumerate(OFFSETS):
        inb = ((ty + di >= 0) & (ty + di < gh) & (tx + dj >= 0)
               & (tx + dj < gw))
        nb = _shift2d(centers, -di, -dj)             # seed (y+di, x+dj)
        cf = _upsample_grid(nb, step)
        ok = _upsample_grid(inb[..., None], step)[..., 0]
        d0 = lab[0] - cf[..., 0]
        d1 = lab[1] - cf[..., 1]
        d2 = lab[2] - cf[..., 2]
        dc2 = (d0 * d0 + d1 * d1) + d2 * d2
        dy = py - cf[..., 3]
        dx = px - cf[..., 4]
        ds2 = dy * dy + dx * dx
        d = dc2 + (ds2 * sw) * m2
        take = ok & (d < best_d)
        best_d = torch.where(take, d, best_d)
        best_o = torch.where(take, oi, best_o)
    tile_y = torch.arange(cfg.pad_h, device=dev)[:, None] // step
    tile_x = torch.arange(cfg.pad_w, device=dev)[None, :] // step
    labels = (tile_y + best_o // 3 - 1) * gw + (tile_x + best_o % 3 - 1)
    return labels.to(torch.int32), best_o


def pool(lab_p, best_o, cfg: SlicConfig):
    """Per-(tile, offset) sums of [L, a, b, y, x, 1] over the valid pixels:
    (gh, gw, 9, 6) f32."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = best_o.device
    hp, wp = cfg.pad_h, cfg.pad_w
    py, px = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev),
                            torch.arange(wp, dtype=torch.float32, device=dev),
                            indexing='ij')
    chans = [lab_p[0].float(), lab_p[1].float(), lab_p[2].float(), py, px,
             torch.ones_like(py)]
    data = torch.stack(chans, dim=-1)
    valid = (py < cfg.height) & (px < cfg.width)
    parts = []
    for oi in range(9):
        mask = (best_o == oi) & valid
        parts.append((data * mask.to(torch.float32)[..., None])
                     .reshape(gh, step, gw, step, -1).sum(dim=(1, 3)))
    return torch.stack(parts, dim=2)


def update_centers(partials, centers):
    """New centres from (gh, gw, 9, 6) partials; empty clusters keep
    theirs."""
    sums = combine_sums(partials[..., :6])
    cnt = sums[..., 5:6]
    new = sums[..., :5] / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt > 0, new, centers[..., :5])


def slic_rounds(lab_p, centers, compactness, cfg: SlicConfig, n_upd):
    """``n_upd`` assign + pool + update rounds; the final centres."""
    sw, m2 = slic_weights(compactness, cfg)
    for _ in range(n_upd):
        _, best_o = assign(lab_p, centers, sw, m2, cfg)
        centers = update_centers(pool(lab_p, best_o, cfg), centers)
    return centers


def slic_labels(lab_p, centers, compactness, cfg: SlicConfig):
    """The final assignment: (pad_h, pad_w) int32 labels."""
    sw, m2 = slic_weights(compactness, cfg)
    return assign(lab_p, centers, sw, m2, cfg)[0]
