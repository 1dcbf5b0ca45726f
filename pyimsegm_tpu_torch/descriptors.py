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
