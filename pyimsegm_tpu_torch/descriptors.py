"""Superpixel colour and gray features (port of the colour and gray parts
of ``pyimsegm_tpu.descriptors``).

The same feature-flag surface (``{'color[_<space>]': [stats...]}``) and the
same feature naming and ordering: ``color-ch1_mean``, ``lab-ch2_std``, ...
for colour images, ``gray_mean``, ``gray_std``, ... for gray images and
volumes.  The texture keys (``tLM``, ``tGabor``, ``tLBP``) raise
``NotImplementedError`` until the supervised slice brings the filter banks
(ROADMAP.md).
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.ops import color as color_ops
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

_TEXTURE_PREFIXES = ('tLM', 'tGabor', 'tLBP')


def _check_keys(dict_features):
    texture = [k for k in dict_features if k.startswith(_TEXTURE_PREFIXES)]
    if texture:
        raise NotImplementedError(
            'texture features %r come with the supervised slice (ROADMAP.md)'
            % texture)
    unknown = [k for k in dict_features if not k.startswith('color')]
    if unknown:
        raise ValueError('unrecognised feature groups: %r' % unknown)


def compute_selected_features_color2d(image, seg_ids, num_segments,
                                      dict_features, grid_ctx=None):
    """Features of a 2D colour image over flat superpixel ids.

    :param image: (H, W, 3) float tensor
    :param seg_ids: (H*W,) integer labels in [0, num_segments)
    :param dict_features: e.g. ``{'color': ('mean', 'std'),
        'color_hsv': ('median',)}``
    :param grid_ctx: optional (labels2d, SlicConfig) of grid-structured
        labels, which take the grid reduce
    :returns: ((num_segments, F) features, list of F names)
    """
    _check_keys(dict_features)
    image = image.to(torch.float32)
    feats, names = [], []
    for key in dict_features:
        space = key.split('_')[-1] if '_' in key else 'rgb'
        img_c = (color_ops.convert_img_color_from_rgb(image, space)
                 if '_' in key else image)
        flags = tuple(dict_features[key])
        feats.append(segment_stats.compute_channel_statistics(
            img_c, seg_ids, num_segments, flags, grid_ctx=grid_ctx))
        prefix = space if '_' in key else 'color'
        names += segment_stats.statistic_names(
            ['%s-ch%i' % (prefix, i + 1) for i in range(3)], flags)
    features = torch.nan_to_num(torch.cat(feats, dim=-1))
    if features.shape[1] != len(names):
        raise ValueError('features %r vs names %i'
                         % (tuple(features.shape), len(names)))
    return features, names


def _gray_flags(dict_features):
    """The union of the colour keys' flags, in canonical order."""
    _check_keys(dict_features)
    if not dict_features:
        raise ValueError('no feature groups given')
    flags = set(np.concatenate([list(v) for v in dict_features.values()]))
    return tuple(f for f in NAMES_FEATURE_FLAGS if f in flags)


def compute_selected_features_gray2d(image, seg_ids, num_segments,
                                     dict_features, grid_ctx=None):
    """Intensity statistics of a 2D gray image: one set of the union of the
    colour keys' flags, named ``gray_<flag>``; over grid-structured
    superpixels with a grid context, else as a volume of one slice
    (:func:`compute_selected_features_gray3d`)."""
    flags = _gray_flags(dict_features)
    if grid_ctx is None:
        return compute_selected_features_gray3d(image[None], seg_ids,
                                                num_segments, dict_features)
    features = segment_stats.compute_channel_statistics(
        image.to(torch.float32)[..., None], seg_ids, num_segments, flags,
        grid_ctx=grid_ctx)
    return torch.nan_to_num(features), ['gray_%s' % f for f in flags]


def compute_selected_features_gray3d(volume, seg_ids, num_segments,
                                     dict_features, grid_ctx3d=None):
    """Intensity statistics of a gray volume: one set of the union of the
    colour keys' flags, named ``gray_<flag>``.

    :param volume: (Z, H, W) float tensor
    :param seg_ids: (Z*H*W,) integer labels in [0, num_segments)
    :param grid_ctx3d: optional (labels3d, Slic3DConfig) of SLIC
        supervoxels, whose mean / std / energy take the 27-offset grid sums
    :returns: ((num_segments, F) features, list of F names)
    """
    flags = _gray_flags(dict_features)
    features = _gray3d_statistics(volume.to(torch.float32), seg_ids,
                                  num_segments, flags, grid_ctx3d=grid_ctx3d)
    return torch.nan_to_num(features), ['gray_%s' % f for f in flags]


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
