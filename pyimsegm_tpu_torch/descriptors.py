"""Superpixel colour features (port of the colour part of
``pyimsegm_tpu.descriptors``).

The same feature-flag surface (``{'color[_<space>]': [stats...]}``) and the
same feature naming and ordering: ``color-ch1_mean``, ``lab-ch2_std``, ...
The texture keys (``tLM``, ``tGabor``, ``tLBP``) raise ``NotImplementedError``
until the supervised slice brings the filter banks (ROADMAP.md).
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


def compute_selected_features_gray2d(image, seg_ids, num_segments,
                                     dict_features, grid_ctx=None):
    """Intensity statistics of a 2D gray image over grid-structured
    superpixels: one set of the union of the colour keys' flags, named
    ``gray_<flag>``.  Without a grid context the JAX package takes its 3D
    path, which comes with the 3D slice (ROADMAP.md)."""
    _check_keys(dict_features)
    if grid_ctx is None or not dict_features:
        raise NotImplementedError('gray features without a SLIC grid come '
                                  'with the 3D slice (ROADMAP.md)')
    flags = set(np.concatenate([list(v) for v in dict_features.values()]))
    flags = tuple(f for f in NAMES_FEATURE_FLAGS if f in flags)
    features = segment_stats.compute_channel_statistics(
        image.to(torch.float32)[..., None], seg_ids, num_segments, flags,
        grid_ctx=grid_ctx)
    return torch.nan_to_num(features), ['gray_%s' % f for f in flags]


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
