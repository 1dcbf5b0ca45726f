"""Superpixel colour, texture and gray features (port of
``pyimsegm_tpu.descriptors``).

The same feature-flag surface (``{'color[_<space>]': [stats...],
'tLM[_short]': [stats...], 'tGabor': [stats...], 'tLBP': [...]}``) and the
same feature naming and ordering: ``color-ch1_mean``, ``lab-ch2_std``,
``tLM_sigma1.4-edge-ch1_mean``, ``tGabor_sigma2.0-freq0.10-gabor-ch1_mean``,
``tLBP-ch1_bin0``, ... for colour images, ``gray_mean``, ``gray_std``, ...
and ``tLM_<filter>_<flag>`` for gray images and volumes (whose texture is
the LM bank's alone: the other texture keys are left out there, as the
reference leaves them).
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.ops import color as color_ops
from pyimsegm_tpu_torch.ops import filters as filter_ops
from pyimsegm_tpu_torch.ops import segment_stats
from pyimsegm_tpu_torch.utils.device import as_tensor

#: statistic flags in canonical order
NAMES_FEATURE_FLAGS = segment_stats.NAMES_FEATURE_FLAGS
#: feature-set presets
FEATURES_SET_ALL = {
    'color': ('mean', 'std', 'energy', 'median', 'meanGrad'),
    'tLM': ('mean', 'std', 'energy', 'median', 'meanGrad'),
}
FEATURES_SET_COLOR = {'color': ('mean', 'std', 'energy')}
FEATURES_SET_TEXTURE = {'tLM': ('mean', 'std', 'energy')}
FEATURES_SET_TEXTURE_SHORT = {'tLM_short': ('mean', 'std', 'energy')}

_BANK_CACHE = {}


def _get_bank(bank_type):
    """The LM bank: ``'short'`` (3 sigmas, 4 orientations) or the full one."""
    if bank_type not in _BANK_CACHE:
        if bank_type == 'short':
            _BANK_CACHE[bank_type] = filter_ops.create_filter_bank_lm_2d(
                sigmas=filter_ops.SHORT_FILTERS_SIGMAS, nb_orient=4)
        else:
            _BANK_CACHE[bank_type] = filter_ops.create_filter_bank_lm_2d()
    return _BANK_CACHE[bank_type]


def _get_gabor_bank():
    if 'gabor' not in _BANK_CACHE:
        _BANK_CACHE['gabor'] = filter_ops.create_filter_bank_gabor_2d()
    return _BANK_CACHE['gabor']


def compute_selected_features_color2d(image, seg_ids, num_segments,
                                      dict_features, grid_ctx=None):
    """Features of a 2D colour image over flat superpixel ids: the colour
    keys, then the LM, Gabor and LBP texture keys, each group in the order
    of the dict.

    :param image: (H, W, 3) float tensor
    :param seg_ids: (H*W,) integer labels in [0, num_segments)
    :param dict_features: e.g. ``{'color': ('mean', 'std'),
        'tGabor': ('mean', 'energy'), 'tLBP': ('mean',)}``
    :param grid_ctx: optional (labels2d, SlicConfig) of grid-structured
        labels, which take the grid reduce
    :returns: ((num_segments, F) features, list of F names)
    """
    image = image.to(torch.float32)
    feats, names = [], []
    color_keys = [k for k in dict_features if k.startswith('color')]
    for key in color_keys:
        space = key.split('_')[-1] if '_' in key else 'rgb'
        img_c = (color_ops.convert_img_color_from_rgb(image, space)
                 if '_' in key else image)
        flags = tuple(dict_features[key])
        feats.append(segment_stats.compute_channel_statistics(
            img_c, seg_ids, num_segments, flags, grid_ctx=grid_ctx))
        prefix = space if '_' in key else 'color'
        names += segment_stats.statistic_names(
            ['%s-ch%i' % (prefix, i + 1) for i in range(3)], flags)

    lm_keys = [k for k in dict_features if k.startswith('tLM')]
    for key in lm_keys:
        f, n = _texture_features_color2d(
            image, seg_ids, num_segments, tuple(dict_features[key]),
            key.split('_')[-1] if '_' in key else 'normal', grid_ctx=grid_ctx)
        feats.append(f)
        names += n

    gabor_keys = [k for k in dict_features if k.startswith('tGabor')]
    for key in gabor_keys:
        f, n = _texture_battery_features(image, seg_ids, num_segments,
                                         tuple(dict_features[key]),
                                         _get_gabor_bank(), 'tGabor',
                                         grid_ctx=grid_ctx)
        feats.append(f)
        names += n

    lbp_keys = [k for k in dict_features if k.startswith('tLBP')]
    for _key in lbp_keys:
        f, n = filter_ops.lbp_histogram_features(image, seg_ids, num_segments,
                                                 grid_ctx=grid_ctx)
        feats.append(f)
        names += n

    unknown = [k for k in dict_features
               if k not in color_keys + lm_keys + gabor_keys + lbp_keys]
    if unknown:
        raise ValueError('unrecognised feature groups: %r' % unknown)
    features = torch.nan_to_num(torch.cat(feats, dim=-1))
    if features.shape[1] != len(names):
        raise ValueError('features %r vs names %i'
                         % (tuple(features.shape), len(names)))
    return features, names


def _texture_features_color2d(image, seg_ids, num_segments, flags, bank_type,
                              grid_ctx=None):
    """LM texture statistics of a colour image."""
    return _texture_battery_features(image, seg_ids, num_segments, flags,
                                     _get_bank(bank_type), 'tLM',
                                     grid_ctx=grid_ctx)


def _texture_battery_features(image, seg_ids, num_segments, flags, bank,
                              prefix, grid_ctx=None):
    """Per-superpixel statistics of a filter bank's battery responses.

    The reference normalises each battery response by
    ``log(1 + ||r||) / 0.03 / ||r||`` before its statistics.  That scale is
    linear per battery, so every statistic commutes with it (mean, std,
    median and meanGrad by ``s``, energy by ``s**2``), and ``||r||**2`` is
    the total of the per-superpixel energy sums: the B batteries' moments
    ride one reduction of the raw (H, W, B*C) stack (row 7 over grid
    labels) and the scales are applied to the (K, B*C) statistics.

    :returns: ((K, B * C * n_flags) features, names), battery-major, then
        flag, then channel
    """
    img = filter_ops.subtract_background(image.to(torch.float32), sigma=150.0)
    raw = filter_ops.filter_bank_raw(img, bank)              # (B, H, W, C)
    b, h, w, c = raw.shape
    stack = raw.permute(1, 2, 0, 3).reshape(h, w, b * c)     # battery-major
    del raw
    if grid_ctx is not None:
        from pyimsegm_tpu_torch.ops.grid import grid_geometry_moments
        labels2d, cfg = grid_ctx
        msums = grid_geometry_moments(stack, labels2d, cfg)  # (K, 2BC+3)
        sums = msums[:, :2 * b * c]
        cnt = msums[:, 2 * b * c:2 * b * c + 1]
    else:
        ones = torch.ones((h, w, 1), dtype=torch.float32, device=stack.device)
        asums = segment_stats._reduce_sums(
            torch.cat([stack, stack * stack, ones], -1), seg_ids,
            num_segments, None)                              # (K, 2BC+1)
        sums, cnt = asums[:, :-1], asums[:, -1:]
    safe = torch.clamp_min(cnt, 1.0)
    mean_r = sums[:, :b * c] / safe
    energy_sums = sums[:, b * c:2 * b * c]
    energy_r = energy_sums / safe
    std_r = torch.sqrt(torch.clamp_min(energy_r - mean_r * mean_r, 0.0))
    scales = filter_ops.battery_norm_scales(
        torch.sum(energy_sums.reshape(num_segments, b, c), dim=(0, 2)))

    if 'median' in flags:
        median_r = segment_stats.segment_median(
            stack.reshape(-1, b * c), seg_ids, num_segments)
    if 'meanGrad' in flags:
        grad = torch.stack([segment_stats.image_gradient_sum(stack[..., i])
                            for i in range(b * c)], dim=-1)
        ones = torch.ones((h, w, 1), dtype=torch.float32, device=stack.device)
        gsum = segment_stats._reduce_sums(torch.cat([grad, ones], -1),
                                          seg_ids, num_segments, grid_ctx)
        grad_r = gsum[:, :b * c] / torch.clamp_min(gsum[:, -1:], 1.0)

    feats, names = [], []
    for bi, bname in enumerate(bank.names):
        s = scales[bi]
        cols = slice(bi * c, (bi + 1) * c)
        blocks = {'mean': s * mean_r[:, cols], 'std': s * std_r[:, cols],
                  'energy': (s * s) * energy_r[:, cols]}
        if 'median' in flags:
            blocks['median'] = s * median_r[:, cols]
        if 'meanGrad' in flags:
            blocks['meanGrad'] = s * grad_r[:, cols]
        feats.append(torch.cat([blocks[f] for f in NAMES_FEATURE_FLAGS
                                if f in flags], dim=-1))
        names += segment_stats.statistic_names(
            ['%s_%s-ch%i' % (prefix, bname, i + 1) for i in range(c)], flags)
    return torch.cat(feats, dim=-1), names


def feature_names(dict_features, gray3d=False):
    """Names only (no compute) of the colour and LM keys of a feature
    spec, as the reference's ``feature_names``."""
    names = []
    for key in [k for k in dict_features if k.startswith('color')]:
        flags = tuple(dict_features[key])
        if gray3d:
            names += ['gray_%s' % f for f in NAMES_FEATURE_FLAGS
                      if f in flags]
        else:
            space = key.split('_')[-1] if '_' in key else 'color'
            names += segment_stats.statistic_names(
                ['%s-ch%i' % (space, i + 1) for i in range(3)], flags)
    for key in [k for k in dict_features if k.startswith('tLM')]:
        flags = tuple(dict_features[key])
        bank = _get_bank(key.split('_')[-1] if '_' in key else 'normal')
        for bname in bank.names:
            if gray3d:
                names += ['tLM_%s_%s' % (bname, f) for f in flags]
            else:
                names += segment_stats.statistic_names(
                    ['tLM_%s-ch%i' % (bname, i + 1) for i in range(3)], flags)
    return names


def _canonical(flags):
    return tuple(f for f in NAMES_FEATURE_FLAGS if f in flags)


def _color_flags(dict_features, color_keys):
    """The union of the colour keys' flags, in canonical order."""
    return _canonical(set(np.concatenate([list(dict_features[k])
                                          for k in color_keys])))


def compute_selected_features_gray2d(image, seg_ids, num_segments,
                                     dict_features, grid_ctx=None):
    """Features of a 2D gray image: the intensity statistics of the union of
    the colour keys' flags (``gray_<flag>``) over the grid reduce where a
    grid context and a colour key are given, and the rest as a volume of one
    slice (:func:`compute_selected_features_gray3d`)."""
    color_keys = [k for k in dict_features if k.startswith('color')]
    other = {k: v for k, v in dict_features.items() if k not in color_keys}
    if grid_ctx is None or not color_keys:
        return compute_selected_features_gray3d(image[None], seg_ids,
                                                num_segments, dict_features)
    flags = _color_flags(dict_features, color_keys)
    feats = [segment_stats.compute_channel_statistics(
        image.to(torch.float32)[..., None], seg_ids, num_segments, flags,
        grid_ctx=grid_ctx)]
    names = ['gray_%s' % f for f in flags]
    if other:
        f3, n3 = compute_selected_features_gray3d(image[None], seg_ids,
                                                  num_segments, other)
        feats.append(f3)
        names += n3
    return torch.nan_to_num(torch.cat(feats, dim=-1)), names


def compute_selected_features_gray3d(volume, seg_ids, num_segments,
                                     dict_features, grid_ctx3d=None):
    """Features of a gray volume: the intensity statistics of the union of
    the colour keys' flags (``gray_<flag>``), then the LM texture of each
    ``tLM[_short]`` key (``tLM_<filter>_<flag>``); other keys are left out,
    and a spec with neither raises ``ValueError``.

    :param volume: (Z, H, W) float tensor
    :param seg_ids: (Z*H*W,) integer labels in [0, num_segments)
    :param grid_ctx3d: optional (labels3d, Slic3DConfig) of SLIC
        supervoxels, whose mean / std / energy take the 27-offset grid sums
    :returns: ((num_segments, F) features, list of F names)
    """
    volume = volume.to(torch.float32)
    feats, names = [], []
    color_keys = [k for k in dict_features if k.startswith('color')]
    if color_keys:
        flags = _color_flags(dict_features, color_keys)
        feats.append(_gray3d_statistics(volume, seg_ids, num_segments, flags,
                                         grid_ctx3d=grid_ctx3d))
        names += ['gray_%s' % f for f in flags]
    for key in [k for k in dict_features if k.startswith('tLM')]:
        f, n = _texture_features_gray3d(
            volume, seg_ids, num_segments, tuple(dict_features[key]),
            key.split('_')[-1] if '_' in key else 'normal',
            grid_ctx3d=grid_ctx3d)
        feats.append(f)
        names += n
    if not feats:
        raise ValueError('no colour or tLM feature group in %r'
                         % list(dict_features))
    return torch.nan_to_num(torch.cat(feats, dim=-1)), names


def _texture_features_gray3d(volume, seg_ids, num_segments, flags, bank_type,
                             grid_ctx3d=None):
    """LM texture statistics of a gray volume: each z-slice's background
    subtracted and its bank response normalised on its own, as the
    reference treats the slices, then the statistics of each battery's
    response volume over the supervoxels.  The slices ride one bank
    convolution as its channels.

    :returns: ((K, n_batteries * n_flags) features, names
        ``tLM_<filter>_<flag>``)
    """
    bank = _get_bank(bank_type)
    img = torch.stack([filter_ops.subtract_background(
        volume[z][..., None], 150.0)[..., 0]
        for z in range(volume.shape[0])], dim=-1)            # (H, W, Z)
    raw = filter_ops.filter_bank_raw(img, bank)              # (B, H, W, Z)
    scales = filter_ops.battery_norm_scales(torch.sum(raw * raw, dim=(1, 2)))
    canon = _canonical(flags)
    feats, names = [], []
    for bi, bname in enumerate(bank.names):
        resp = (raw[bi] * scales[bi]).permute(2, 0, 1)       # (Z, H, W)
        feats.append(_gray3d_statistics(resp, seg_ids, num_segments, canon,
                                        grid_ctx3d=grid_ctx3d))
        names += ['tLM_%s_%s' % (bname, f) for f in flags]
    return torch.cat(feats, dim=-1), names


def _gray3d_statistics(volume, seg_ids, num_segments, flags, grid_ctx3d=None):
    """(K, len(flags)) statistics of a (Z, H, W) volume in canonical order;
    meanGrad is the segment mean of each slice's 2D gradient sum."""
    flat = volume.reshape(-1, 1)
    moment_flags = tuple(f for f in ('mean', 'std', 'energy') if f in flags)
    blocks = {}
    if moment_flags and grid_ctx3d is not None:
        from pyimsegm_tpu_torch.ops.slic3d import grid3d_segment_sum
        labels3d, cfg3 = grid_ctx3d
        sums = grid3d_segment_sum(
            torch.stack([volume, volume * volume, torch.ones_like(volume)],
                        dim=-1), labels3d, cfg3)
        blocks.update(segment_stats.moment_blocks(sums[:, :2], sums[:, 2]))
    elif moment_flags:
        blocks.update(segment_stats.segment_mean_std_energy(
            flat, seg_ids, num_segments, flags=moment_flags))
    if 'median' in flags:
        blocks['median'] = segment_stats.segment_median(flat, seg_ids,
                                                        num_segments)
    if 'meanGrad' in flags:
        gy, gx = torch.gradient(volume, dim=(1, 2))
        blocks['meanGrad'] = segment_stats.segment_mean_std_energy(
            (gy + gx).reshape(-1, 1), seg_ids, num_segments,
            flags=('mean',))['mean']
    return torch.cat([blocks[f] for f in flags], dim=-1)


def compute_selected_features_img2d(image, seg_ids, num_segments,
                                    dict_features, grid_ctx=None):
    """(H, W, 3) -> colour statistics, (H, W) -> gray statistics."""
    if image.ndim == 3 and image.shape[-1] == 3:
        return compute_selected_features_color2d(
            image, seg_ids, num_segments, dict_features, grid_ctx=grid_ctx)
    if image.ndim == 2:
        return compute_selected_features_gray2d(
            image, seg_ids, num_segments, dict_features, grid_ctx=grid_ctx)
    raise ValueError('invalid image size - %r' % (tuple(image.shape),))


# -------------------------------------------------- windowed label hists ---

def adjust_bounding_box_crop(image_size, element_size, position):
    """Clip a window centred at ``position`` to the image; returns
    (im_begin, im_end, el_begin, el_end) per axis.

    >>> adjust_bounding_box_crop((10, 10), (5, 5), (2, 2))
    ((0, 0), (5, 5), (0, 0), (5, 5))
    """
    im_begin, im_end, el_begin, el_end = [], [], [], []
    for dim in range(len(element_size)):
        half = element_size[dim] // 2
        lo = int(position[dim]) - half
        hi = lo + element_size[dim]
        im_begin.append(max(lo, 0))
        im_end.append(min(hi, image_size[dim]))
        el_begin.append(max(-lo, 0))
        el_end.append(element_size[dim] - max(hi - image_size[dim], 0))
    return tuple(im_begin), tuple(im_end), tuple(el_begin), tuple(el_end)


def compute_label_hist_segm(segm, position, struc_elem, nb_labels):
    """Label histogram inside a structuring element around a point (host).

    >>> segm = np.zeros((10, 10), dtype=int)
    >>> segm[1:9, 2:8] = 1
    >>> segm[3:7, 4:6] = 2
    >>> compute_label_hist_segm(segm, [6, 6], np.ones((3, 3)), 3)
    (array([0., 7., 2.]), 9.0)
    """
    segm = np.asarray(segm)
    struc_elem = np.asarray(struc_elem)
    if segm.ndim != len(position):
        raise ValueError('dim of position %r should match the segmentation'
                         ' %r dim' % (position, segm.shape))
    ib, ie, bb, be = adjust_bounding_box_crop(segm.shape, struc_elem.shape,
                                              position)
    sel = segm[ib[0]:ie[0], ib[1]:ie[1]]
    el = struc_elem[bb[0]:be[0], bb[1]:be[1]]
    if sel.shape != el.shape:
        raise ValueError('segmentation %s and element %s should match'
                         % (sel.shape, el.shape))
    hist = np.zeros(nb_labels)
    for lb in range(nb_labels):
        hist[lb] = np.sum((sel == lb) & (el == 1))
    return hist, float(np.sum(struc_elem))


def compute_label_hist_proba(segm, position, struc_elem):
    """Windowed histogram over per-label probability planes (host).

    >>> seg = np.zeros((50, 50, 2), dtype=float)
    >>> seg[15:35, 20:40, 1] = 1
    >>> seg[:, :, 0] = 1 - seg[:, :, 1]
    >>> compute_label_hist_proba(seg, (15, 20), np.ones((12, 13), dtype=int))
    (array([114.,  42.]), 156)
    """
    segm = np.asarray(segm)
    struc_elem = np.asarray(struc_elem)
    if segm.ndim != (len(position) + 1):
        raise ValueError('segment. (%r) should have larger (+1) dim than'
                         ' position %i' % (segm.shape, len(position)))
    ib, ie, bb, be = adjust_bounding_box_crop(segm.shape[:struc_elem.ndim],
                                              struc_elem.shape, position)
    sel = segm[ib[0]:ie[0], ib[1]:ie[1], :]
    el = struc_elem[bb[0]:be[0], bb[1]:be[1]]
    hist = np.sum(sel * el[..., None], axis=(0, 1))
    return hist, int(np.sum(struc_elem))


def norm_features(features, scaler=None):
    """Standard-score normalisation with a reusable (mean, std) scaler."""
    features = np.asarray(features, float)
    if scaler is None:
        scaler = (features.mean(axis=0), features.std(axis=0) + 1e-12)
    mu, sd = scaler
    return (features - mu) / sd, scaler


# ------------------- per-statistic twins (host reference + device) ---------
# The reference exposes numpy_* / cython_* implementation pairs: here the
# numpy_* twins are host numpy and the cython_* ones the device segment
# reduction of ``ops/segment_stats`` on ``device``.

def _label_counts(seg, nb_lbs):
    counts = np.bincount(np.asarray(seg).ravel(),
                         minlength=nb_lbs).astype(float)
    counts[counts == 0] = -1   # empty segments: 0 / -1 = 0
    return counts


def numpy_img2d_color_mean(img, seg):
    """Per-segment channel means, host numpy.

    >>> img = np.array([[[1., 0., 0.]] * 3 + [[0., 1., 0.]] * 3] * 2)
    >>> seg = np.array([[0] * 3 + [1] * 3] * 2)
    >>> numpy_img2d_color_mean(img, seg)
    array([[1., 0., 0.],
           [0., 1., 0.]])
    """
    img, seg = np.asarray(img, float), np.asarray(seg)
    nb = int(seg.max()) + 1
    counts = _label_counts(seg, nb)
    sums = np.stack([np.bincount(seg.ravel(), weights=img[..., c].ravel(),
                                 minlength=nb)
                     for c in range(img.shape[-1])], 1)
    return sums / counts[:, None]


def numpy_img2d_color_energy(img, seg):
    """Per-segment channel mean of squares."""
    img = np.asarray(img, float)
    return numpy_img2d_color_mean(img ** 2, seg)


def numpy_img2d_color_std(img, seg, means=None):
    """Per-segment channel standard deviation (population)."""
    if means is None:
        means = numpy_img2d_color_mean(img, seg)
    energy = numpy_img2d_color_energy(img, seg)
    return np.sqrt(np.maximum(energy - np.asarray(means) ** 2, 0.0))


def numpy_img2d_color_median(img, seg):
    """Per-segment channel median."""
    img, seg = np.asarray(img, float), np.asarray(seg)
    nb = int(seg.max()) + 1
    flat_seg = seg.ravel()
    flat = img.reshape(-1, img.shape[-1])
    out = np.zeros((nb, img.shape[-1]))
    for lb in range(nb):
        sel = flat[flat_seg == lb]
        if len(sel):
            out[lb] = np.median(sel, axis=0)
    return out


def numpy_img3d_gray_mean(img, seg):
    """Per-segment means over a gray volume."""
    img, seg = np.asarray(img, float), np.asarray(seg)
    nb = int(seg.max()) + 1
    counts = _label_counts(seg, nb)
    sums = np.bincount(seg.ravel(), weights=img.ravel(), minlength=nb)
    return sums / counts


def numpy_img3d_gray_energy(img, seg):
    """Per-segment mean of squares over a gray volume."""
    return numpy_img3d_gray_mean(np.asarray(img, float) ** 2, seg)


def numpy_img3d_gray_std(img, seg, means=None):
    """Per-segment standard deviation over a gray volume."""
    if means is None:
        means = numpy_img3d_gray_mean(img, seg)
    energy = numpy_img3d_gray_energy(img, seg)
    return np.sqrt(np.maximum(energy - np.asarray(means) ** 2, 0.0))


def numpy_img3d_gray_median(img, seg):
    """Per-segment median over a gray volume."""
    img, seg = np.asarray(img, float), np.asarray(seg)
    nb = int(seg.max()) + 1
    out = np.zeros(nb)
    flat_seg, flat = seg.ravel(), img.ravel()
    for lb in range(nb):
        sel = flat[flat_seg == lb]
        if len(sel):
            out[lb] = np.median(sel)
    return out


def _segment_ids(seg, device):
    """(flat int64 labels on ``device`` (or the tensor's), segment count)."""
    ids = as_tensor(seg, device).reshape(-1).to(torch.int64)
    return ids, int(ids.max()) + 1


def _device_stat(img, seg, stat, channels, device):
    ids, nb = _segment_ids(seg, device)
    flat = as_tensor(img, ids.device, torch.float32).to(ids.device).reshape(
        -1, channels)
    res = segment_stats.segment_mean_std_energy(flat, ids, nb, flags=(stat,))
    return np.asarray(torch.nan_to_num(res[stat]).cpu().numpy(), float)


def cython_img2d_color_mean(img, seg, device='cuda'):
    """Device twin of :func:`numpy_img2d_color_mean`."""
    return _device_stat(img, seg, 'mean', np.shape(img)[-1], device)


def cython_img2d_color_energy(img, seg, device='cuda'):
    """Device twin of :func:`numpy_img2d_color_energy`."""
    return _device_stat(img, seg, 'energy', np.shape(img)[-1], device)


def cython_img2d_color_std(img, seg, means=None, device='cuda'):
    """Device twin of :func:`numpy_img2d_color_std`; ``means`` is taken
    for the signature and not used (the reduction has its own)."""
    return _device_stat(img, seg, 'std', np.shape(img)[-1], device)


def cython_img3d_gray_mean(img, seg, device='cuda'):
    """Device twin of :func:`numpy_img3d_gray_mean`."""
    return _device_stat(img, seg, 'mean', 1, device)[:, 0]


def cython_img3d_gray_energy(img, seg, device='cuda'):
    """Device twin of :func:`numpy_img3d_gray_energy`."""
    return _device_stat(img, seg, 'energy', 1, device)[:, 0]


def cython_img3d_gray_std(img, seg, mean=None, device='cuda'):
    """Device twin of :func:`numpy_img3d_gray_std` (``mean`` unused)."""
    return _device_stat(img, seg, 'std', 1, device)[:, 0]


def cython_label_hist_seg2d(segm_select, struc_elem, nb_labels):
    """Label histogram of a pre-cropped window under a binary element.

    >>> segm = np.zeros((10, 10), dtype=int)
    >>> segm[1:9, 2:8] = 1
    >>> cython_label_hist_seg2d(segm[5:8, 5:8], np.ones((3, 3)), 2)
    array([0., 9.])
    """
    segm_select = np.asarray(segm_select)
    struc_elem = np.asarray(struc_elem)
    if segm_select.shape != struc_elem.shape:
        raise ValueError('segm %r and element %r should match'
                         % (segm_select.shape, struc_elem.shape))
    sel = segm_select[struc_elem == 1]
    return np.bincount(sel.ravel(),
                       minlength=nb_labels).astype(float)[:nb_labels]


# -------------------------------------------- statistic dispatchers --------

def _canonical_flags(feature_flags):
    return tuple(f for f in NAMES_FEATURE_FLAGS if f in tuple(feature_flags))


def compute_image2d_color_statistic(image, segm,
                                    feature_flags=NAMES_FEATURE_FLAGS,
                                    color_name='color', device='cuda'):
    """Per-segment statistics of a colour 2D image over its 2D label map,
    on ``device``.

    :returns: ((nb_segments, F) numpy features, list of F names)
    """
    ids, nb = _segment_ids(segm, device)
    flags = _canonical_flags(feature_flags)
    image = as_tensor(image, ids.device, torch.float32).to(ids.device)
    feats = segment_stats.compute_channel_statistics(image, ids, nb, flags)
    ch = ['%s-ch%i' % (color_name, i + 1) for i in range(image.shape[-1])]
    return (torch.nan_to_num(feats).cpu().numpy(),
            segment_stats.statistic_names(ch, flags))


def compute_image3d_gray_statistic(image, segm,
                                   feature_flags=NAMES_FEATURE_FLAGS,
                                   ch_name='gray', device='cuda'):
    """Per-segment statistics of a gray 3D volume, on ``device``.

    :returns: ((nb_segments, F) numpy features, list of F names)
    """
    ids, nb = _segment_ids(segm, device)
    flags = _canonical_flags(feature_flags)
    volume = as_tensor(image, ids.device, torch.float32).to(ids.device)
    feats = _gray3d_statistics(volume, ids, nb, flags)
    return (torch.nan_to_num(feats).cpu().numpy(),
            ['%s_%s' % (ch_name, f) for f in flags])


def compute_texture_desc_lm_img2d_clr(img, seg, feature_flags,
                                      bank_type='normal', device='cuda'):
    """LM texture statistics of a colour image, on ``device``."""
    ids, nb = _segment_ids(seg, device)
    image = as_tensor(img, ids.device, torch.float32).to(ids.device)
    feats, names = _texture_features_color2d(
        image, ids, nb, _canonical_flags(feature_flags), bank_type)
    return torch.nan_to_num(feats).cpu().numpy(), names


def compute_texture_desc_lm_img3d_val(img, seg, feature_flags,
                                      bank_type='normal', device='cuda'):
    """LM texture statistics of a gray volume, on ``device``: per-z-slice
    bank responses reduced per 3D segment."""
    ids, nb = _segment_ids(seg, device)
    volume = as_tensor(img, ids.device, torch.float32).to(ids.device)
    feats, names = _texture_features_gray3d(
        volume, ids, nb, _canonical_flags(feature_flags), bank_type)
    return torch.nan_to_num(feats).cpu().numpy(), names


# ------------------------------------------------ filter-bank helpers ------

def make_gaussian_filter1d(vals, sigma, order=0):
    """1D (derivative-of-)Gaussian response, L1-normalised."""
    if order > 2:
        raise ValueError('only orders up to 2 are supported')
    return filter_ops._gaussian_1d(np.asarray(vals, float), sigma, order)


def make_edge_filter2d(sig, phase, points, sup):
    """Oriented edge / bar filter from sampled points."""
    return filter_ops._edge_filter_2d(sig, phase, np.asarray(points, float),
                                      sup)


def compute_img_filter_response2d(img, filter_battery):
    """Response of one filter battery, the maximum over its oriented
    filters, on the host (the pipelines take
    :func:`pyimsegm_tpu_torch.ops.filters.filter_bank_raw`)."""
    from scipy import ndimage
    battery = np.asarray(filter_battery, float)
    if battery.ndim == 2:
        battery = battery[None]
    img = np.asarray(img, float)
    resp = np.stack([ndimage.convolve(img, k) for k in battery])
    resp = resp[0] if len(resp) == 1 else resp.max(axis=0)
    return np.clip(resp, -filter_ops.MAX_SIGNAL_RESPONSE,
                   filter_ops.MAX_SIGNAL_RESPONSE)


def compute_img_filter_response3d(img, filter_battery):
    """Battery response of each z-slice of a volume."""
    img = np.asarray(img, float)
    return np.stack([compute_img_filter_response2d(img[z], filter_battery)
                     for z in range(img.shape[0])])


def image_subtract_gauss_smooth(img, sigma):
    """Subtract a per-slice Gaussian background, z-slices independent."""
    from scipy.ndimage import gaussian_filter
    img = np.asarray(img, float)
    if sigma <= 0:
        return img
    return img - np.stack([gaussian_filter(img[z], sigma)
                           for z in range(img.shape[0])])


# ------------------------------------------------------- ray twins ---------

def numpy_ray_features_seg2d(seg_binary, position, angle_step=5., edge='up'):
    """Host march, one ray at a time: from ``position`` step along each
    angle until the boundary condition is met; -1 when the ray leaves the
    image.

    >>> seg = np.ones((100, 150), dtype=bool)
    >>> yy, xx = np.mgrid[:100, :150]
    >>> seg[((yy - 50) ** 2 + (xx - 75) ** 2) <= 40 ** 2] = False
    >>> numpy_ray_features_seg2d(seg, (50, 75), 45).astype(int)[:4]
    array([41, 41, 41, 41])
    """
    seg_binary = np.asarray(seg_binary).astype(bool)
    angles = np.arange(0, 360, angle_step)
    ray_dist = np.full(len(angles), -1.0)
    if seg_binary[int(position[0]), int(position[1])] and edge == 'up':
        return ray_dist * 0
    height, width = seg_binary.shape
    diag = int(np.hypot(height, width))
    for i, ang in enumerate(angles):
        rad = np.deg2rad(ang)
        grad = np.array([np.sin(rad), np.cos(rad)])
        grad = grad / max(np.abs(grad))
        pos = np.array(position, float)
        last = seg_binary[int(position[0]), int(position[1])]
        for _ in range(diag):
            pos = pos + grad
            r, c = int(round(pos[0])), int(round(pos[1]))
            if pos[0] < 0 or r >= height or pos[1] < 0 or c >= width:
                break
            actual = seg_binary[r, c]
            if (edge == 'up' and actual) or (edge == 'down' and last
                                             and not actual):
                ray_dist[i] = np.hypot(*(pos - np.asarray(position, float)))
                break
            last = actual
    return ray_dist


def cython_ray_features_seg2d(seg_binary, position, angle_step=5., edge='up',
                              device='cuda'):
    """The batched march of :mod:`pyimsegm_tpu_torch.ops.ray` for one
    position, under the reference's name of its compiled twin."""
    from pyimsegm_tpu_torch.ops import ray as ray_ops
    return np.asarray(ray_ops.compute_ray_features_segm_2d(
        seg_binary, position, angle_step=angle_step, smooth_coef=0,
        edge=edge, device=device), float)


def compute_ray_features_segm_2d_vectors(seg_binary, position, angle_step=5.,
                                         smooth_coef=0, edge='up',
                                         device='cuda'):
    """The reference's rotation-based ray variant, with the same output
    contract as :func:`compute_ray_features_segm_2d`, computed by the
    direct march."""
    from pyimsegm_tpu_torch.ops import ray as ray_ops
    return np.asarray(ray_ops.compute_ray_features_segm_2d(
        seg_binary, position, angle_step=angle_step, smooth_coef=smooth_coef,
        edge=edge, device=device), float)


# -------------------------- public re-exports under the reference's names ---

from pyimsegm_tpu_torch.ops.histogram import (  # noqa: E402,F401
    HIST_CIRCLE_DIAGONALS,
    compute_label_histograms_positions,
)
from pyimsegm_tpu_torch.ops.ray import (  # noqa: E402,F401
    compute_ray_features_positions,
    compute_ray_features_segm_2d,
    interpolate_ray_dist,
    reconstruct_ray_features_2d,
    reduce_close_points,
    shift_ray_features,
)
from pyimsegm_tpu_torch.ops.filters import (  # noqa: E402,F401
    create_filter_bank_lm_2d,
)
