"""SLIC assignment + pooling and centre update: CUDA kernels and twins.

Replaces the SLIC kernels of ``pyimsegm_tpu.ops.slic_pallas``
(``slic_multi_update_pallas``, ``slic_update_labels_pallas``,
``slic_assign_pallas``, ``slic_update_pallas``) with the two kernels of
``csrc/slic.cu``:

* ``slic_assign_pool`` — one block per seed tile: each pixel takes the first
  best of its 9 candidate seeds (row-major ``(di, dj)`` order) under
  ``d = dc2 + (ds2 * sw) * m2`` (SLICO: ``dc2 / max(M, 1e-6) + ds2 * sw``
  with the cluster's colour normaliser M), and the block writes the labels,
  or per-(tile, offset) partial sums [L, a, b, y, x, count] (+ [v, v^2] of a
  feature image; + the largest dc2 in SLICO mode), or both; for the final
  assignment a second launch routes the partials to per-seed sums in
  :func:`combine_sums`'s order;
* ``slic_schedule`` — the whole update schedule (row 2) in one cooperative
  launch: each round assigns and pools every tile and updates its centres
  (route the 9 offset partials as :func:`combine_sums` does, divide, keep
  the centre of an empty cluster; in SLICO mode also M = max(routed largest
  dc2, 1)), with one grid barrier per round.

:func:`slic_multi_update` is one ``slic_schedule`` call, counted once per
schedule;
:func:`slic_update_labels` is one assign_pool with labels, partials (and
features) and the routed sums; :func:`slic_assign` writes labels only,
:func:`slic_update` partials only.  Each wrapper launches the kernels for
CUDA tensors and runs the plain twins (``_assign_plain``, ``_pool_plain``,
``_update_centers_plain``) for CPU tensors.
"""

import ctypes
import functools

import numpy as np
import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.grid import _shift2d
from pyimsegm_tpu_torch.ops.slic import (
    SlicConfig, _upsample_grid, slic_weights)

OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]
#: kernel launches in this process, per wrapper (the multi-updates count
#: one per schedule)
LAUNCHES = {'slic_multi_update': 0, 'slic_multi_update_slico': 0,
            'slic_update_labels': 0, 'slic_assign': 0, 'slic_assign_slico': 0,
            'slic_update': 0}


@functools.cache
def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('slic', {
        'slic_assign_pool': [v] * 6 + [f, f] + [i] * 6 + [v],
        'slic_schedule': [v] * 4 + [f] * 3 + [i] * 7 + [v],
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

def _assign_plain(lab_p, centers, sw, m2, cfg: SlicConfig, slico=False):
    """First-best of the 9 candidate seeds per pixel.

    :param lab_p: (3, pad_h, pad_w) Lab planes (bf16 ok)
    :param centers: (gh, gw, 5) f32; (gh, gw, 6) with M in column 5 when
        ``slico``
    :returns: (labels (pad_h, pad_w) int32, winning offset (pad_h, pad_w),
        colour distance dc2 to the winner (pad_h, pad_w))
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
    best_dc2 = torch.zeros((cfg.pad_h, cfg.pad_w), dtype=torch.float32,
                           device=dev)
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
        if slico:
            d = dc2 / torch.clamp_min(cf[..., 5], 1e-6) + ds2 * sw
        else:
            d = dc2 + (ds2 * sw) * m2
        take = ok & (d < best_d)
        best_d = torch.where(take, d, best_d)
        best_o = torch.where(take, oi, best_o)
        best_dc2 = torch.where(take, dc2, best_dc2)
    tile_y = torch.arange(cfg.pad_h, device=dev)[:, None] // step
    tile_x = torch.arange(cfg.pad_w, device=dev)[None, :] // step
    labels = (tile_y + best_o // 3 - 1) * gw + (tile_x + best_o % 3 - 1)
    return labels.to(torch.int32), best_o, best_dc2


def _pool_plain(lab_p, best_o, cfg: SlicConfig, feat=None, best_dc2=None):
    """Per-(tile, offset) sums of [L, a, b, y, x, 1] (+ [v, v^2] of the
    (H, W, 3) image ``feat``) over the valid pixels, and with ``best_dc2``
    (SLICO) the largest dc2 as a last channel: (gh, gw, 9, 6|7|12) f32."""
    gh, gw, step = cfg.grid_h, cfg.grid_w, cfg.step
    dev = best_o.device
    hp, wp = cfg.pad_h, cfg.pad_w
    py, px = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev),
                            torch.arange(wp, dtype=torch.float32, device=dev),
                            indexing='ij')
    chans = [lab_p[0].float(), lab_p[1].float(), lab_p[2].float(), py, px,
             torch.ones_like(py)]
    if feat is not None:
        feat_chw = torch.zeros((3, hp, wp), dtype=torch.float32, device=dev)
        feat_chw[:, :cfg.height, :cfg.width] = feat.permute(2, 0, 1)
        chans += [feat_chw[c] for c in range(3)]
        chans += [feat_chw[c] * feat_chw[c] for c in range(3)]
    data = torch.stack(chans, dim=-1)
    valid = (py < cfg.height) & (px < cfg.width)
    parts = []
    for oi in range(9):
        mask = (best_o == oi) & valid
        part = (data * mask.to(torch.float32)[..., None]) \
            .reshape(gh, step, gw, step, -1).sum(dim=(1, 3))
        if best_dc2 is not None:
            mx = torch.where(mask, best_dc2, 0.0) \
                .reshape(gh, step, gw, step).amax(dim=(1, 3))
            part = torch.cat([part, mx[..., None]], dim=-1)
        parts.append(part)
    return torch.stack(parts, dim=2)


def _update_centers_plain(partials, centers, slico=False):
    """New centres from (gh, gw, 9, 6|7) partials; empty clusters keep
    theirs.  With ``slico`` column 5 becomes max(routed largest dc2, 1)."""
    sums = combine_sums(partials[..., :6])
    cnt = sums[..., 5:6]
    new = sums[..., :5] / torch.clamp_min(cnt, 1.0)
    new = torch.where(cnt > 0, new, centers[..., :5])
    if not slico:
        return new
    mx = torch.zeros(partials.shape[:2], dtype=torch.float32,
                     device=partials.device)
    for oi, (di, dj) in enumerate(OFFSETS):
        mx = torch.maximum(mx, _shift2d(partials[:, :, oi, 6], di, dj))
    return torch.cat([new, torch.clamp_min(mx, 1.0)[..., None]], dim=-1)


def _init_slico(centers, compactness):
    """(gh, gw, 6) centres with every colour normaliser M seeded at m**2."""
    m2 = float(np.float32(compactness) ** 2)
    m = torch.full(centers.shape[:2] + (1,), m2, dtype=torch.float32,
                   device=centers.device)
    return torch.cat([centers[..., :5].to(torch.float32), m], dim=-1)


def _slic_multi_update_plain(lab_chw, centers, compactness, cfg, n_upd,
                             slico=False):
    if slico:
        centers = _init_slico(centers, compactness)
    for _ in range(n_upd):
        centers = _update_centers_plain(
            _slic_update_plain(lab_chw, centers, compactness, cfg, slico),
            centers, slico)
    return centers


def _slic_update_labels_plain(lab_chw, centers, compactness, cfg,
                              feat=None):
    sw, m2 = slic_weights(compactness, cfg)
    labels, best_o, _ = _assign_plain(lab_chw, centers, sw, m2, cfg)
    partials = _pool_plain(lab_chw, best_o, cfg, feat)
    return labels, partials, combine_sums(partials)


def _slic_assign_plain(lab_chw, centers, compactness, cfg, slico=False):
    sw, m2 = slic_weights(compactness, cfg)
    return _assign_plain(lab_chw, centers, sw, m2, cfg, slico)[0]


def _slic_update_plain(lab_chw, centers, compactness, cfg, slico=False):
    sw, m2 = slic_weights(compactness, cfg)
    _, best_o, dc2 = _assign_plain(lab_chw, centers, sw, m2, cfg, slico)
    return _pool_plain(lab_chw, best_o, cfg, best_dc2=dc2 if slico else None)


# ---------------------------------------------------------------- kernels ---

def _check_inputs(lab_chw, centers, cfg, slico=False):
    _build.require(lab_chw, 'lab_chw', torch.bfloat16,
                   (3, cfg.pad_h, cfg.pad_w))
    _build.require(centers, 'centers', torch.float32,
                   (cfg.grid_h, cfg.grid_w, 6 if slico else 5))


def _launch_assign_pool(lab_chw, centers, feat, labels, partials, sw, m2,
                        cfg: SlicConfig, slico=False, sums=None):
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.launch(_lib().slic_assign_pool, 'slic_assign_pool', lab_chw,
                  lab_chw.data_ptr(), centers.data_ptr(), ptr(feat),
                  ptr(labels), ptr(partials), ptr(sums), ctypes.c_float(sw),
                  ctypes.c_float(m2), cfg.height, cfg.width, cfg.grid_h,
                  cfg.grid_w, cfg.step, int(slico))


def slic_multi_update(lab_chw, centers, compactness, cfg: SlicConfig, n_upd,
                      slico=False):
    """Run ``n_upd`` assign + update rounds; returns new centres.  On the
    card the whole schedule is one cooperative launch (``slic_schedule``),
    counted here once; a launch the card refuses raises.

    :param lab_chw: (3, pad_h, pad_w) bf16 Lab planes
    :param centers: (gh, gw, 5) f32 [l, a, b, y, x]
    :param compactness: SLIC compactness m
    :param slico: adaptive per-cluster compactness (skimage ``slic_zero``):
        the colour normaliser M of every cluster seeds at m**2 and becomes
        max(largest dc2 of its pixels, 1) at each update
    :returns: (gh, gw, 5) f32 centres; (gh, gw, 6) with M in column 5 when
        ``slico``
    """
    if not lab_chw.is_cuda:
        return _slic_multi_update_plain(lab_chw, centers, compactness, cfg,
                                        n_upd, slico)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers[..., :5].to(torch.float32).contiguous()
    _check_inputs(lab_chw, centers, cfg)
    nc, pch = (6, 7) if slico else (5, 6)
    k = cfg.n_segments
    out = centers.new_empty((cfg.grid_h, cfg.grid_w, nc))
    scratch = centers.new_empty((2 * k * (nc + 9 * pch),))
    _build.launch(_lib().slic_schedule, 'slic_schedule', lab_chw,
                  lab_chw.data_ptr(), centers.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), ctypes.c_float(sw), ctypes.c_float(m2),
                  ctypes.c_float(float(np.float32(compactness) ** 2)),
                  cfg.height, cfg.width, cfg.grid_h, cfg.grid_w, cfg.step,
                  max(int(n_upd), 0), int(slico))
    LAUNCHES['slic_multi_update_slico' if slico else 'slic_multi_update'] += 1
    return out


def slic_update_labels(lab_chw, centers, compactness, cfg: SlicConfig,
                       feat=None):
    """Final assignment: labels, partials and their per-seed sums from one
    C call (the pass and the route), optionally with the colour moments of
    ``feat``.

    :param feat: (H, W, 3) image whose [v, v^2] are pooled too, or None
    :returns: (labels (pad_h, pad_w) int32, partials (gh, gw, 9, 6|12) f32,
        per-seed sums (gh, gw, 6|12) f32 routed as :func:`combine_sums`
        does: [L, a, b, y, x, count(, v0, v1, v2, v0^2, v1^2, v2^2)])
    """
    if not lab_chw.is_cuda:
        return _slic_update_labels_plain(lab_chw, centers, compactness, cfg,
                                         feat)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(lab_chw, centers, cfg)
    ch = 6
    if feat is not None:
        ch = 12
        feat = feat.to(torch.float32).contiguous()
        _build.require(feat, 'feat', torch.float32,
                       (cfg.height, cfg.width, 3))
    dev = lab_chw.device
    labels = torch.empty((cfg.pad_h, cfg.pad_w), dtype=torch.int32, device=dev)
    partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, ch),
                           dtype=torch.float32, device=dev)
    sums = torch.empty((cfg.grid_h, cfg.grid_w, ch), dtype=torch.float32,
                       device=dev)
    _launch_assign_pool(lab_chw, centers, feat, labels, partials, sw, m2, cfg,
                        sums=sums)
    LAUNCHES['slic_update_labels'] += 1
    return labels, partials, sums


def slic_assign(lab_chw, centers, compactness, cfg: SlicConfig, slico=False):
    """Final assignment pass, labels only.

    :param centers: (gh, gw, 5) f32; (gh, gw, 6) with the colour normaliser
        M in column 5 when ``slico`` (from :func:`slic_multi_update`)
    :returns: (pad_h, pad_w) int32 labels
    """
    if not lab_chw.is_cuda:
        return _slic_assign_plain(lab_chw, centers, compactness, cfg, slico)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(lab_chw, centers, cfg, slico)
    labels = torch.empty((cfg.pad_h, cfg.pad_w), dtype=torch.int32,
                         device=lab_chw.device)
    _launch_assign_pool(lab_chw, centers, None, labels, None, sw, m2, cfg,
                        slico)
    LAUNCHES['slic_assign_slico' if slico else 'slic_assign'] += 1
    return labels


def slic_update(lab_chw, centers, compactness, cfg: SlicConfig, slico=False):
    """One assignment pass that writes only the update partials.

    :param centers: (gh, gw, 5) f32; (gh, gw, 6) with M when ``slico``
    :returns: (gh, gw, 9, 6) f32 per-(tile, offset) sums of
        [L, a, b, y, x, count]; with ``slico`` a seventh channel holds the
        largest dc2 of the pixels that took the offset
    """
    if not lab_chw.is_cuda:
        return _slic_update_plain(lab_chw, centers, compactness, cfg, slico)
    sw, m2 = slic_weights(compactness, cfg)
    centers = centers.to(torch.float32).contiguous()
    _check_inputs(lab_chw, centers, cfg, slico)
    partials = torch.empty((cfg.grid_h, cfg.grid_w, 9, 7 if slico else 6),
                           dtype=torch.float32, device=lab_chw.device)
    _launch_assign_pool(lab_chw, centers, None, None, partials, sw, m2, cfg,
                        slico)
    LAUNCHES['slic_update'] += 1
    return partials


def slic_iteration(lab_chw, centers, compactness, cfg: SlicConfig):
    """(labels, partials) of one assignment, as two passes
    (:func:`slic_assign`, :func:`slic_update`), the split the JAX package's
    ``slic_iteration_pallas`` makes."""
    return (slic_assign(lab_chw, centers, compactness, cfg),
            slic_update(lab_chw, centers, compactness, cfg))
