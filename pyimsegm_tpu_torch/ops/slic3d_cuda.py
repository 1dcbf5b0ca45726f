"""3D SLIC assignment + pooling and centre update: CUDA kernels and twins.

Replaces ``slic3d_iterate_pallas`` of ``pyimsegm_tpu.ops.slic3d_pallas``
with the two kernels of ``csrc/slic3d.cu``:

* ``slic3d_pass`` -- one block per seed tile: each voxel takes the first
  best of its 27 candidate seeds (lexicographic ``(dz, dy, dx)`` order)
  under ``d = dc2 + ds2 * sw * m2``, and the block writes either the labels
  of its voxels or per-(tile, offset) partial sums [v, z, y, x, count] over
  the valid voxels;
* ``slic3d_update`` -- one thread per seed: route the 27 offset partials
  (:func:`combine_sums3d`), divide, keep the centre of an empty cluster.

:func:`slic3d_iterate` runs n_iter - 1 rounds of (:func:`slic3d_partials`,
the centre update) and a last :func:`slic3d_labels`.  Each wrapper launches
its kernel for CUDA tensors and runs the plain twin (``_assign3d_plain``,
``_pool3d_plain``, ``_update3d_plain``) for CPU tensors.
"""

import ctypes
import functools

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.slic3d import (
    OFFSETS3, Slic3DConfig, _shift3d, _upsample3d, slic3d_weights)

#: kernel launches in this process, per wrapper (``slic3d_iterate`` counts
#: its centre updates; its passes count as ``slic3d_partials`` and
#: ``slic3d_labels``)
LAUNCHES = {'slic3d_labels': 0, 'slic3d_partials': 0, 'slic3d_iterate': 0}
_BIG = 1e10


@functools.cache
def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('slic3d', {
        'slic3d_pass': [v] * 4 + [f] * 5 + [i] * 9 + [v],
        'slic3d_update': [v, v, i, i, i, v],
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

def _check_inputs(vol_p, centers, cfg):
    _build.require(vol_p, 'vol_p', torch.float32, cfg.pad)
    _build.require(centers, 'centers', torch.float32, cfg.grid + (4,))


def _launch_pass(vol_p, centers, labels, partials, compactness,
                 cfg: Slic3DConfig):
    (sp_z, sp_y, sp_x), sw, m2 = slic3d_weights(compactness, cfg)
    ptr = (lambda t: None if t is None else t.data_ptr())
    f = ctypes.c_float
    err = _lib().slic3d_pass(
        vol_p.data_ptr(), centers.data_ptr(), ptr(labels), ptr(partials),
        f(sp_z), f(sp_y), f(sp_x), f(sw), f(m2), *cfg.shape, *cfg.grid,
        *cfg.steps, _build.stream_ptr(vol_p))
    _build.check(err, 'slic3d_pass')


def slic3d_labels(vol_p, centers, compactness, cfg: Slic3DConfig):
    """Assignment pass, labels only.

    :param vol_p: (pad_z, pad_h, pad_w) f32 normalised, edge-padded volume
    :param centers: (gz, gy, gx, 4) f32 [v, z, y, x]
    :returns: (pad_z, pad_h, pad_w) int32 labels
    """
    if not vol_p.is_cuda:
        return _slic3d_labels_plain(vol_p, centers, compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(vol_p, centers, cfg)
    labels = torch.empty(cfg.pad, dtype=torch.int32, device=vol_p.device)
    with torch.cuda.device(vol_p.device):
        _launch_pass(vol_p, centers, labels, None, compactness, cfg)
    LAUNCHES['slic3d_labels'] += 1
    return labels


def slic3d_partials(vol_p, centers, compactness, cfg: Slic3DConfig):
    """Assignment pass that writes only the update partials.

    :returns: (gz, gy, gx, 27, 5) f32 per-(tile, offset) sums of
        [v, z, y, x, count] over the valid voxels
    """
    if not vol_p.is_cuda:
        return _slic3d_partials_plain(vol_p, centers, compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(vol_p, centers, cfg)
    partials = torch.empty(cfg.grid + (len(OFFSETS3), 5), dtype=torch.float32,
                           device=vol_p.device)
    with torch.cuda.device(vol_p.device):
        _launch_pass(vol_p, centers, None, partials, compactness, cfg)
    LAUNCHES['slic3d_partials'] += 1
    return partials


def slic3d_iterate(vol_p, centers0, compactness, cfg: Slic3DConfig, n_iter):
    """The whole SLIC schedule: n_iter - 1 rounds of a partials pass and a
    centre update (one launch each, no host synchronisation), then a labels
    pass.  Each centre update is counted here.

    :returns: (pad_z, pad_h, pad_w) int32 labels
    """
    if not vol_p.is_cuda:
        return _slic3d_iterate_plain(vol_p, centers0, compactness, cfg,
                                     n_iter)
    centers = centers0.to(torch.float32).contiguous().clone()
    _check_inputs(vol_p, centers, cfg)
    with torch.cuda.device(vol_p.device):
        for _ in range(max(n_iter - 1, 0)):
            partials = slic3d_partials(vol_p, centers, compactness, cfg)
            err = _lib().slic3d_update(partials.data_ptr(), centers.data_ptr(),
                                       *cfg.grid, _build.stream_ptr(vol_p))
            _build.check(err, 'slic3d_update')
            LAUNCHES['slic3d_iterate'] += 1
    return slic3d_labels(vol_p, centers, compactness, cfg)
