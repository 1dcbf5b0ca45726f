"""Superpixel features of the benchmark's two entries (frozen from the
port's ``descriptors``): the colour statistics and the LM texture of a
colour image over grid-structured SLIC labels (``color`` and
``tLM[_short]`` keys), and the gray statistics of a volume over SLIC
supervoxels (``color`` keys).  Named as the port names them:
``color-ch1_mean``, ``tLM_sigma1.4-edge-ch1_mean``, ``gray_mean``, ...
"""

import numpy as np
import torch

from portbench.reference.frozen.ops import filters as filter_ops
from portbench.reference.frozen.ops import segment_stats

#: statistic flags in canonical order
NAMES_FEATURE_FLAGS = segment_stats.NAMES_FEATURE_FLAGS
#: the statistics the reference computes (one moment reduction)
MOMENT_FLAGS = ('mean', 'std', 'energy')

_BANK_CACHE = {}


def _moment_flags(flags):
    flags = tuple(flags)
    if not set(flags) <= set(MOMENT_FLAGS):
        raise ValueError('the reference computes %r, not %r'
                         % (MOMENT_FLAGS, flags))
    return flags


def _get_bank(bank_type):
    """The LM bank: ``'short'`` (3 sigmas, 4 orientations) or the full one."""
    if bank_type not in _BANK_CACHE:
        if bank_type == 'short':
            _BANK_CACHE[bank_type] = filter_ops.create_filter_bank_lm_2d(
                sigmas=filter_ops.SHORT_FILTERS_SIGMAS, nb_orient=4)
        else:
            _BANK_CACHE[bank_type] = filter_ops.create_filter_bank_lm_2d()
    return _BANK_CACHE[bank_type]


def compute_selected_features_color2d(image, seg_ids, num_segments,
                                      dict_features, grid_ctx):
    """Features of a 2D colour image over grid-structured superpixels: the
    ``color`` key's statistics, then each ``tLM[_short]`` key's, in the
    order of the dict.

    :param image: (H, W, 3) float tensor
    :param seg_ids: (H*W,) integer labels in [0, num_segments)
    :param dict_features: e.g. ``{'color': ('mean', 'std', 'energy'),
        'tLM_short': ('mean',)}``
    :param grid_ctx: (labels2d, SlicConfig) of the SLIC labels
    :returns: ((num_segments, F) features, list of F names)
    """
    image = image.to(torch.float32)
    feats, names = [], []
    for key, flags in dict_features.items():
        flags = _moment_flags(flags)
        if key == 'color':
            feats.append(segment_stats.compute_channel_statistics(
                image, seg_ids, num_segments, flags, grid_ctx=grid_ctx))
            names += segment_stats.statistic_names(
                ['color-ch%i' % (i + 1) for i in range(3)], flags)
        elif key in ('tLM', 'tLM_short'):
            f, n = _texture_features_color2d(
                image, seg_ids, num_segments, flags,
                'short' if key == 'tLM_short' else 'normal', grid_ctx)
            feats.append(f)
            names += n
        else:
            raise ValueError('the reference has no feature group %r' % key)
    features = torch.nan_to_num(torch.cat(feats, dim=-1))
    if features.shape[1] != len(names):
        raise ValueError('features %r vs names %i'
                         % (tuple(features.shape), len(names)))
    return features, names


def _texture_features_color2d(image, seg_ids, num_segments, flags, bank_type,
                              grid_ctx):
    """LM texture statistics of a colour image."""
    return _texture_battery_features(image, seg_ids, num_segments, flags,
                                     _get_bank(bank_type), 'tLM',
                                     grid_ctx=grid_ctx)


def _texture_battery_features(image, seg_ids, num_segments, flags, bank,
                              prefix, grid_ctx):
    """Per-superpixel statistics of a filter bank's battery responses.

    The reference normalises each battery response by
    ``log(1 + ||r||) / 0.03 / ||r||`` before its statistics.  That scale is
    linear per battery, so every statistic commutes with it (mean, std,
    median and meanGrad by ``s``, energy by ``s**2``), and ``||r||**2`` is
    the total of the per-superpixel energy sums: the B batteries' moments
    ride one reduction of the raw (H, W, B*C) stack over the grid labels
    and the scales are applied to the (K, B*C) statistics.

    :returns: ((K, B * C * n_flags) features, names), battery-major, then
        flag, then channel
    """
    img = filter_ops.subtract_background(image.to(torch.float32), sigma=150.0)
    raw = filter_ops.filter_bank_raw(img, bank)              # (B, H, W, C)
    b, h, w, c = raw.shape
    stack = raw.permute(1, 2, 0, 3).reshape(h, w, b * c)     # battery-major
    del raw
    from portbench.reference.frozen.ops.grid import grid_geometry_moments
    labels2d, cfg = grid_ctx
    msums = grid_geometry_moments(stack, labels2d, cfg)      # (K, 2BC+3)
    sums = msums[:, :2 * b * c]
    cnt = msums[:, 2 * b * c:2 * b * c + 1]
    safe = torch.clamp_min(cnt, 1.0)
    mean_r = sums[:, :b * c] / safe
    energy_sums = sums[:, b * c:2 * b * c]
    energy_r = energy_sums / safe
    std_r = torch.sqrt(torch.clamp_min(energy_r - mean_r * mean_r, 0.0))
    scales = filter_ops.battery_norm_scales(
        torch.sum(energy_sums.reshape(num_segments, b, c), dim=(0, 2)))

    feats, names = [], []
    for bi, bname in enumerate(bank.names):
        s = scales[bi]
        cols = slice(bi * c, (bi + 1) * c)
        blocks = {'mean': s * mean_r[:, cols], 'std': s * std_r[:, cols],
                  'energy': (s * s) * energy_r[:, cols]}
        feats.append(torch.cat([blocks[f] for f in NAMES_FEATURE_FLAGS
                                if f in flags], dim=-1))
        names += segment_stats.statistic_names(
            ['%s_%s-ch%i' % (prefix, bname, i + 1) for i in range(c)], flags)
    return torch.cat(feats, dim=-1), names


def _canonical(flags):
    return tuple(f for f in NAMES_FEATURE_FLAGS if f in flags)


def _color_flags(dict_features, color_keys):
    """The union of the colour keys' flags, in canonical order."""
    return _canonical(set(np.concatenate([list(dict_features[k])
                                          for k in color_keys])))


def compute_selected_features_gray3d(volume, seg_ids, num_segments,
                                     dict_features, grid_ctx3d):
    """Features of a gray volume over SLIC supervoxels: the intensity
    statistics of the union of the ``color`` keys' flags (``gray_<flag>``).

    :param volume: (Z, H, W) float tensor
    :param seg_ids: (Z*H*W,) integer labels in [0, num_segments)
    :param grid_ctx3d: (labels3d, Slic3DConfig) of the supervoxels, whose
        moments take the 27-offset grid sums
    :returns: ((num_segments, F) features, list of F names)
    """
    from portbench.reference.frozen.ops.slic3d import grid3d_segment_sum
    unknown = [k for k in dict_features if not k.startswith('color')]
    if unknown or not dict_features:
        raise ValueError('the reference has gray statistics alone, not %r'
                         % list(dict_features))
    flags = _moment_flags(_color_flags(dict_features, list(dict_features)))
    volume = volume.to(torch.float32)
    labels3d, cfg3 = grid_ctx3d
    sums = grid3d_segment_sum(
        torch.stack([volume, volume * volume, torch.ones_like(volume)],
                    dim=-1), labels3d, cfg3)
    blocks = segment_stats.moment_blocks(sums[:, :2], sums[:, 2])
    features = torch.cat([blocks[f] for f in flags], dim=-1)
    return torch.nan_to_num(features), ['gray_%s' % f for f in flags]


def compute_selected_features_img2d(image, seg_ids, num_segments,
                                    dict_features, grid_ctx):
    """(H, W, 3) -> colour and texture statistics."""
    if image.ndim == 3 and image.shape[-1] == 3:
        return compute_selected_features_color2d(
            image, seg_ids, num_segments, dict_features, grid_ctx)
    raise ValueError('invalid image size - %r' % (tuple(image.shape),))
