"""SLIC assignment + pooling and centre update: CUDA kernels and twins.

Replaces ``pyimsegm_tpu.ops.slic_pallas.slic_multi_update_pallas`` and
``slic_update_labels_pallas`` with the two kernels of ``csrc/slic.cu``:

* ``slic_assign_pool`` — one block per seed tile: each pixel takes the first
  best of its 9 candidate seeds (row-major ``(di, dj)`` order) under
  ``d = dc2 + (ds2 * sw) * m2``, and the block writes per-(tile, offset)
  partial sums [L, a, b, y, x, count] (+ [v, v^2] of a feature image);
  optionally the labels;
* ``slic_update`` — one thread per seed: route the 9 offset partials
  (:func:`combine_sums`), divide, keep the centre of an empty cluster.

:func:`slic_multi_update` is a host loop of n_upd x (assign_pool, update);
:func:`slic_update_labels` is one assign_pool with labels (and features).
Each wrapper launches the kernels for CUDA tensors and runs the plain twins
(``_assign_plain``, ``_pool_plain``, ``_update_centers_plain``) for CPU
tensors.
"""

import ctypes

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.grid import _shift2d
from pyimsegm_tpu_torch.ops.slic import (
    SlicConfig, _upsample_grid, slic_weights)

OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]
#: kernel launches in this process, per wrapper (slic_multi_update counts
#: both of its kernels)
LAUNCHES = {'slic_multi_update': 0, 'slic_update_labels': 0}


def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('slic', {
        'slic_assign_pool': [v] * 5 + [f, f] + [i] * 5 + [v],
        'slic_update': [v, v, i, i, v],
    })


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


# ------------------------------------------------------------ plain twins ---

def _assign_plain(lab_p, centers, sw, m2, cfg: SlicConfig):
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


def _pool_plain(lab_p, best_o, cfg: SlicConfig, feat_chw=None):
    """Per-(tile, offset) sums of [L, a, b, y, x, 1] (+ [v, v^2]) over the
    valid pixels: (gh, gw, 9, 6|12) f32."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = best_o.device
    hp, wp = cfg.pad_h, cfg.pad_w
    py, px = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev),
                            torch.arange(wp, dtype=torch.float32, device=dev),
                            indexing='ij')
    chans = [lab_p[0].float(), lab_p[1].float(), lab_p[2].float(), py, px,
             torch.ones_like(py)]
    if feat_chw is not None:
        chans += [feat_chw[c] for c in range(3)]
        chans += [feat_chw[c] * feat_chw[c] for c in range(3)]
    data = torch.stack(chans, dim=-1)
    valid = (py < cfg.height) & (px < cfg.width)
    parts = []
    for oi in range(9):
        w = ((best_o == oi) & valid).to(torch.float32)[..., None]
        parts.append((data * w).reshape(gh, step, gw, step, -1).sum(dim=(1, 3)))
    return torch.stack(parts, dim=2)


def _update_centers_plain(partials, centers):
    """New centres from (gh, gw, 9, 6) partials; empty clusters keep theirs."""
    sums = combine_sums(partials)
    cnt = sums[..., 5:6]
    new = sums[..., :5] / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt > 0, new, centers)


def _slic_multi_update_plain(lab_chw, centers, compactness, cfg, n_upd):
    sw, m2 = slic_weights(compactness, cfg)
    for _ in range(n_upd):
        _, best_o = _assign_plain(lab_chw, centers, sw, m2, cfg)
        centers = _update_centers_plain(_pool_plain(lab_chw, best_o, cfg),
                                        centers)
    return centers


def _slic_update_labels_plain(lab_chw, centers, compactness, cfg,
                              feat_chw=None):
    sw, m2 = slic_weights(compactness, cfg)
    labels, best_o = _assign_plain(lab_chw, centers, sw, m2, cfg)
    return labels, _pool_plain(lab_chw, best_o, cfg, feat_chw)


# ---------------------------------------------------------------- kernels ---

def _check_inputs(lab_chw, centers, cfg):
    _build.require(lab_chw, 'lab_chw', torch.bfloat16,
                   (3, cfg.pad_h, cfg.pad_w))
    _build.require(centers, 'centers', torch.float32,
                   (cfg.grid_h, cfg.grid_w, 5))


def _launch_assign_pool(lab_chw, centers, feat, labels, partials, sw, m2,
                        cfg: SlicConfig):
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _lib().slic_assign_pool(
        lab_chw.data_ptr(), centers.data_ptr(), ptr(feat), ptr(labels),
        partials.data_ptr(), ctypes.c_float(sw), ctypes.c_float(m2),
        cfg.height, cfg.width, cfg.grid_h, cfg.grid_w, cfg.step,
        _build.stream_ptr(lab_chw))
    _build.check(err, 'slic_assign_pool')


def slic_multi_update(lab_chw, centers, compactness, cfg: SlicConfig, n_upd):
    """Run ``n_upd`` assign + update rounds; returns new (gh, gw, 5) centres.

    :param lab_chw: (3, pad_h, pad_w) bf16 Lab planes
    :param centers: (gh, gw, 5) f32 [l, a, b, y, x]
    :param compactness: SLIC compactness m
    """
    if not lab_chw.is_cuda:
        return _slic_multi_update_plain(lab_chw, centers, compactness, cfg,
                                        n_upd)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers.to(torch.float32).contiguous().clone()
    _check_inputs(lab_chw, centers, cfg)
    partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, 6), dtype=torch.float32,
                           device=lab_chw.device)
    with torch.cuda.device(lab_chw.device):
        for _ in range(n_upd):
            _launch_assign_pool(lab_chw, centers, None, None, partials, sw, m2,
                                cfg)
            LAUNCHES['slic_multi_update'] += 1
            err = _lib().slic_update(partials.data_ptr(), centers.data_ptr(),
                                     cfg.grid_h, cfg.grid_w,
                                     _build.stream_ptr(lab_chw))
            _build.check(err, 'slic_update')
            LAUNCHES['slic_multi_update'] += 1
    return centers


def slic_update_labels(lab_chw, centers, compactness, cfg: SlicConfig,
                       feat_chw=None):
    """Final assignment: labels and partials from one pass, optionally with
    the colour moments of ``feat_chw`` ((3, pad_h, pad_w) f32, zero pad).

    :returns: (labels (pad_h, pad_w) int32, partials (gh, gw, 9, 6|12) f32)
    """
    if not lab_chw.is_cuda:
        return _slic_update_labels_plain(lab_chw, centers, compactness, cfg,
                                         feat_chw)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(lab_chw, centers, cfg)
    ch = 6
    if feat_chw is not None:
        ch = 12
        _build.require(feat_chw, 'feat_chw', torch.float32,
                       (3, cfg.pad_h, cfg.pad_w))
    dev = lab_chw.device
    labels = torch.empty((cfg.pad_h, cfg.pad_w), dtype=torch.int32, device=dev)
    partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, ch),
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch_assign_pool(lab_chw, centers, feat_chw, labels, partials, sw,
                            m2, cfg)
    LAUNCHES['slic_update_labels'] += 1
    return labels, partials
