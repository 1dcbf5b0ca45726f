"""Per-superpixel statistics (frozen from the port's
``ops/segment_stats``): mean, std (population) and energy from one grid
reduction of ``[x, x**2, 1]`` over grid-structured SLIC labels.  Empty
segments give 0 for every statistic.
"""

import torch

#: canonical ordering of statistic flags
NAMES_FEATURE_FLAGS = ('mean', 'std', 'energy', 'median', 'meanGrad')


def moment_blocks(sums, counts):
    """{'mean', 'std' (population), 'energy'}, each (K, C), from (K, 2C)
    sums [sum v, sum v^2] and (K,) counts; empty segments give 0."""
    c = sums.shape[1] // 2
    safe = torch.clamp_min(counts[:, None], 1.0)
    mean = sums[:, :c] / safe
    energy = sums[:, c:] / safe
    return {'mean': mean,
            'std': torch.sqrt(torch.clamp_min(energy - mean * mean, 0.0)),
            'energy': energy}


def compute_channel_statistics(image, seg_ids, num_segments, feature_flags,
                               grid_ctx):
    """The selected moment statistics of an (H, W, C) image over
    grid-structured labels.

    :param image: (H, W, C) float
    :param feature_flags: subset of ('mean', 'std', 'energy')
    :param grid_ctx: (labels2d, SlicConfig) of the SLIC labels
    :returns: (num_segments, C * n_flags), stat-major: all channels of
        'mean', then all of 'std', ...
    """
    from portbench.reference.frozen.ops.grid import grid_segment_sum
    h, w, c = image.shape
    image = image.to(torch.float32)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=image.device)
    labels2d, cfg = grid_ctx
    sums = grid_segment_sum(torch.cat([image, image * image, ones], -1),
                            labels2d, cfg)
    blocks = moment_blocks(sums[:, :-1], sums[:, -1])
    return torch.cat([blocks[f] for f in NAMES_FEATURE_FLAGS
                      if f in feature_flags], dim=-1)


def statistic_names(ch_names, feature_flags):
    """Feature names ``<channel>_<flag>``, stat-major."""
    return ['%s_%s' % (n, flag) for flag in NAMES_FEATURE_FLAGS
            if flag in feature_flags for n in ch_names]
