"""3D SLIC assignment + pooling and centre update: CUDA kernel and twins.

Replaces ``slic3d_iterate_pallas`` of ``pyimsegm_tpu.ops.slic3d_pallas``
with the one cooperative kernel of ``csrc/slic3d.cu`` (``slic3d_run``): a
grid of as many blocks as the card holds co-resident strides over the seed
tiles; each voxel takes the first best of its 27 candidate seeds
(lexicographic ``(dz, dy, dx)`` order) under ``d = dc2 + ds2 * sw * m2``,
and a tile writes either the labels of its voxels or per-(tile, offset)
partial sums [v, z, y, x, count] over the valid voxels.  Between two
partials passes, behind grid barriers, one thread per seed routes the 27
offset partials (:func:`combine_sums3d`'s order), divides, and keeps the
centre of an empty cluster.

:func:`slic3d_iterate` is the whole schedule (n_iter - 1 rounds and the
labels pass) in one launch; :func:`slic3d_labels` and
:func:`slic3d_partials` are single passes of the same kernel.  Each wrapper
launches it for CUDA tensors and runs the plain twin (``_assign3d_plain``,
``_pool3d_plain``, ``_update3d_plain``) for CPU tensors.
"""

import ctypes
import functools

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic3d import (
    OFFSETS3, Slic3DConfig, _shift3d, _upsample3d, slic3d_weights)

#: kernel launches in this process, per wrapper (``slic3d_iterate`` counts
#: one per schedule)
LAUNCHES = {'slic3d_labels': 0, 'slic3d_partials': 0, 'slic3d_iterate': 0}
_BIG = 1e10


@functools.cache
def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('slic3d', {
        'slic3d_run': [v] * 5 + [f] * 5 + [i] * 10 + [v],
    })


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


# ------------------------------------------------------------ plain twins ---

def _coords(cfg: Slic3DConfig, device):
    dp, hp, wp = cfg.pad
    cz = torch.arange(dp, dtype=torch.float32, device=device)[:, None, None]
    cy = torch.arange(hp, dtype=torch.float32, device=device)[None, :, None]
    cx = torch.arange(wp, dtype=torch.float32, device=device)[None, None, :]
    return cz, cy, cx


def _assign3d_plain(vol_p, centers, compactness, cfg: Slic3DConfig,
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


def _pool3d_plain(vol_p, best_o, cfg: Slic3DConfig):
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


def _update3d_plain(partials, centers):
    """New centres from (gz, gy, gx, 27, 5) partials; empty clusters keep
    theirs."""
    sums = combine_sums3d(partials)
    cnt = sums[..., 4:5]
    new = sums[..., :4] / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt > 0, new, centers)


def _slic3d_labels_plain(vol_p, centers, compactness, cfg):
    return _assign3d_plain(vol_p, centers, compactness, cfg)[0]


def _slic3d_partials_plain(vol_p, centers, compactness, cfg):
    _, best_o = _assign3d_plain(vol_p, centers, compactness, cfg,
                                want_labels=False)
    return _pool3d_plain(vol_p, best_o, cfg)


def _slic3d_iterate_plain(vol_p, centers0, compactness, cfg, n_iter):
    centers = centers0
    for _ in range(max(n_iter - 1, 0)):
        centers = _update3d_plain(
            _slic3d_partials_plain(vol_p, centers, compactness, cfg), centers)
    return _slic3d_labels_plain(vol_p, centers, compactness, cfg)


# ---------------------------------------------------------------- kernels ---

def _centers(centers):
    """f32 contiguous centres on a 16-byte boundary (the kernel reads each
    centre as one float4)."""
    centers = centers.to(torch.float32).contiguous()
    return centers.clone() if centers.data_ptr() % 16 else centers


def _check_inputs(vol_p, centers, cfg):
    _build.require(vol_p, 'vol_p', torch.float32, cfg.pad)
    _build.require(centers, 'centers', torch.float32, cfg.grid + (4,))


def _run(vol_p, seeds, work, labels, partials, compactness,
         cfg: Slic3DConfig, n_upd=0):
    (sp_z, sp_y, sp_x), sw, m2 = slic3d_weights(compactness, cfg)
    ptr = (lambda t: None if t is None else t.data_ptr())
    f = ctypes.c_float
    _build.launch(_lib().slic3d_run, 'slic3d_run', vol_p, vol_p.data_ptr(),
                  seeds.data_ptr(), ptr(work), ptr(labels), ptr(partials),
                  f(sp_z), f(sp_y), f(sp_x), f(sw), f(m2), *cfg.shape,
                  *cfg.grid, *cfg.steps, int(n_upd))


def _partials_like(vol_p, cfg):
    return torch.empty(cfg.grid + (len(OFFSETS3), 5), dtype=torch.float32,
                       device=vol_p.device)


def slic3d_labels(vol_p, centers, compactness, cfg: Slic3DConfig):
    """Assignment pass, labels only.

    :param vol_p: (pad_z, pad_h, pad_w) f32 normalised, edge-padded volume
    :param centers: (gz, gy, gx, 4) f32 [v, z, y, x]
    :returns: (pad_z, pad_h, pad_w) int32 labels
    """
    if not vol_p.is_cuda:
        return _slic3d_labels_plain(vol_p, centers, compactness, cfg)
    centers = _centers(centers)
    _check_inputs(vol_p, centers, cfg)
    labels = torch.empty(cfg.pad, dtype=torch.int32, device=vol_p.device)
    _run(vol_p, centers, None, labels, None, compactness, cfg)
    LAUNCHES['slic3d_labels'] += 1
    return labels


def slic3d_partials(vol_p, centers, compactness, cfg: Slic3DConfig):
    """Assignment pass that writes only the update partials.

    :returns: (gz, gy, gx, 27, 5) f32 per-(tile, offset) sums of
        [v, z, y, x, count] over the valid voxels
    """
    if not vol_p.is_cuda:
        return _slic3d_partials_plain(vol_p, centers, compactness, cfg)
    centers = _centers(centers)
    _check_inputs(vol_p, centers, cfg)
    partials = _partials_like(vol_p, cfg)
    _run(vol_p, centers, None, None, partials, compactness, cfg)
    LAUNCHES['slic3d_partials'] += 1
    return partials


def slic3d_iterate(vol_p, centers0, compactness, cfg: Slic3DConfig, n_iter):
    """The whole SLIC schedule: n_iter - 1 rounds of a partials pass and a
    centre update, then a labels pass, in one cooperative launch (counted
    here once); a launch the card refuses raises.

    :returns: (pad_z, pad_h, pad_w) int32 labels
    """
    if not vol_p.is_cuda:
        return _slic3d_iterate_plain(vol_p, centers0, compactness, cfg,
                                     n_iter)
    centers0 = _centers(centers0)
    _check_inputs(vol_p, centers0, cfg)
    n_upd = max(n_iter - 1, 0)
    labels = torch.empty(cfg.pad, dtype=torch.int32, device=vol_p.device)
    work = torch.empty_like(centers0) if n_upd else None
    partials = _partials_like(vol_p, cfg) if n_upd else None
    _run(vol_p, centers0, work, labels, partials, compactness, cfg, n_upd)
    LAUNCHES['slic3d_iterate'] += 1
    return labels
