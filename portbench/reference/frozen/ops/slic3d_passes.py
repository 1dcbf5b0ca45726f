"""The passes of 3D SLIC on the supervoxel seed grid (frozen from the
twins of the port's ``ops/slic3d_cuda``): each voxel takes the first best
of its 27 candidate seeds (lexicographic ``(dz, dy, dx)`` order) under
``d = dc2 + ds2 * sw * m2``; per-(tile, offset) partial sums
[v, z, y, x, count] over the valid voxels are routed to their seeds in
:func:`combine_sums3d`'s order, divided, and an empty cluster keeps its
centre.
"""

import torch

from portbench.reference.frozen.ops.slic3d import (
    OFFSETS3, Slic3DConfig, _shift3d, _upsample3d, slic3d_weights)

_BIG = 1e10


def combine_sums3d(partials):
    """Shift per-offset partials to their target seed and sum.

    :param partials: (gz, gy, gx, 27, CH)
    :returns: (gz, gy, gx, CH) per-seed sums, offsets added in order
    """
    sums = torch.zeros(partials.shape[:3] + partials.shape[4:],
                       dtype=torch.float32, device=partials.device)
    for oi, (dz, dy, dx) in enumerate(OFFSETS3):
        sums = sums + _shift3d(partials[:, :, :, oi], dz, dy, dx)
    return sums


def _coords(cfg: Slic3DConfig, device):
    dp, hp, wp = cfg.pad
    cz = torch.arange(dp, dtype=torch.float32, device=device)[:, None, None]
    cy = torch.arange(hp, dtype=torch.float32, device=device)[None, :, None]
    cx = torch.arange(wp, dtype=torch.float32, device=device)[None, None, :]
    return cz, cy, cx


def assign3d(vol_p, centers, compactness, cfg: Slic3DConfig,
                    want_labels=True):
    """First-best of the 27 candidate seeds per voxel, in the XLA path's
    operation order; candidates off the grid get centres at 1e10.

    :param vol_p: (pad_z, pad_h, pad_w) f32 normalised, edge-padded volume
    :param centers: (gz, gy, gx, 4) f32 [v, z, y, x]
    :returns: (labels (pad_z, pad_h, pad_w) int32 or None, winning offset
        (pad_z, pad_h, pad_w) int64)
    """
    gz, gy, gx = cfg.grid
    (sp_z, sp_y, sp_x), sw, m2 = slic3d_weights(compactness, cfg)
    dev = vol_p.device
    cz, cy, cx = _coords(cfg, dev)
    tz = torch.arange(gz, device=dev)[:, None, None]
    ty = torch.arange(gy, device=dev)[None, :, None]
    tx = torch.arange(gx, device=dev)[None, None, :]
    best_d = torch.full(cfg.pad, _BIG, dtype=torch.float32, device=dev)
    best_o = torch.zeros(cfg.pad, dtype=torch.int64, device=dev)
    best_lb = torch.zeros(cfg.pad, dtype=torch.int32, device=dev) \
        if want_labels else None
    for oi, (dz, dy, dx) in enumerate(OFFSETS3):
        nz, ny, nx = tz + dz, ty + dy, tx + dx
        inb = ((nz >= 0) & (nz < gz) & (ny >= 0) & (ny < gy) & (nx >= 0)
               & (nx < gx))
        nb = torch.where(inb[..., None], _shift3d(centers, -dz, -dy, -dx),
                         _BIG)
        cf = _upsample3d(nb, cfg.steps)
        dv = vol_p - cf[..., 0]
        a = (cz - cf[..., 1]) * sp_z
        b = (cy - cf[..., 2]) * sp_y
        c = (cx - cf[..., 3]) * sp_x
        ds2 = (a * a + b * b) + c * c
        d = dv * dv + (ds2 * sw) * m2
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_o = torch.where(take, oi, best_o)
        if want_labels:
            nb_id = torch.where(inb, (nz * gy + ny) * gx + nx, 0)
            lbf = _upsample3d(nb_id[..., None].to(torch.int32), cfg.steps)
            best_lb = torch.where(take, lbf[..., 0], best_lb)
    return best_lb, best_o


def pool3d(vol_p, best_o, cfg: Slic3DConfig):
    """Per-(tile, offset) sums of [v, z, y, x, 1] over the valid voxels:
    (gz, gy, gx, 27, 5) f32."""
    gz, gy, gx = cfg.grid
    sz, sy, sx = cfg.steps
    dev = vol_p.device
    cz, cy, cx = _coords(cfg, dev)
    z, h, w = cfg.shape
    valid = ((cz < z) & (cy < h) & (cx < w)).to(torch.float32)
    data = torch.stack(torch.broadcast_tensors(
        vol_p, cz, cy, cx, torch.ones_like(vol_p)), dim=-1) * valid[..., None]
    parts = []
    for oi in range(len(OFFSETS3)):
        mask = (best_o == oi).to(torch.float32)[..., None]
        parts.append((data * mask).reshape(gz, sz, gy, sy, gx, sx, 5)
                     .sum(dim=(1, 3, 5)))
    return torch.stack(parts, dim=3)


def update3d(partials, centers):
    """New centres from (gz, gy, gx, 27, 5) partials; empty clusters keep
    theirs."""
    sums = combine_sums3d(partials)
    cnt = sums[..., 4:5]
    new = sums[..., :4] / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt > 0, new, centers)


def slic3d_labels(vol_p, centers, compactness, cfg):
    return assign3d(vol_p, centers, compactness, cfg)[0]


def slic3d_partials(vol_p, centers, compactness, cfg):
    _, best_o = assign3d(vol_p, centers, compactness, cfg,
                                want_labels=False)
    return pool3d(vol_p, best_o, cfg)


def slic3d_iterate(vol_p, centers0, compactness, cfg, n_iter):
    """The whole SLIC schedule: n_iter - 1 rounds of a partials pass and a
    centre update, then a labels pass.

    :returns: (pad_z, pad_h, pad_w) int32 labels
    """
    centers = centers0
    for _ in range(max(n_iter - 1, 0)):
        centers = update3d(
            slic3d_partials(vol_p, centers, compactness, cfg), centers)
    return slic3d_labels(vol_p, centers, compactness, cfg)
