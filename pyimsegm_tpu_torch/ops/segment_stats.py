"""Per-superpixel statistics (port of ``pyimsegm_tpu.ops.segment_stats``).

* mean / std (population) / energy come from one reduction of
  ``[x, x**2, 1]``: the grid reduce (``ops/grid.py``, the ``grid_reduce``
  kernel on the card) for grid-structured SLIC labels, ``index_add_``
  otherwise;
* the median sorts each channel by value, then stably by segment, so each
  segment's values lie in order in one run and the median is two gathers;
* meanGrad is the segment mean of ``np.gradient(channel)`` summed over both
  axes.

Empty segments give 0 for every statistic.
"""

import torch

#: canonical ordering of statistic flags
NAMES_FEATURE_FLAGS = ('mean', 'std', 'energy', 'median', 'meanGrad')


def _segment_sum(data, seg_ids, num_segments):
    """(num_segments, F) f32 sums of (N, F) ``data`` by ``seg_ids``."""
    out = torch.zeros((num_segments, data.shape[-1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, seg_ids.to(torch.int64), data.to(torch.float32))


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


def segment_mean_std_energy(values, seg_ids, num_segments,
                            flags=('mean', 'std', 'energy')):
    """Selected moment statistics.

    :param values: (N, C) float
    :param seg_ids: (N,) integer ids in [0, num_segments)
    :returns: dict of the present statistics, each (num_segments, C)
    """
    values = values.to(torch.float32)
    ones = torch.ones((values.shape[0], 1), dtype=torch.float32,
                      device=values.device)
    sums = _segment_sum(torch.cat([values, values * values, ones], dim=-1),
                        seg_ids, num_segments)
    blocks = moment_blocks(sums[:, :-1], sums[:, -1])
    return {f: blocks[f] for f in ('mean', 'std', 'energy') if f in flags}


def segment_median(values, seg_ids, num_segments):
    """Per-segment median (the mean of the two middle values for an even
    count) by a value sort and a stable segment sort.

    :param values: (N, C)
    :param seg_ids: (N,)
    :returns: (num_segments, C)
    """
    n = values.shape[0]
    seg = seg_ids.to(torch.int64)
    counts = torch.bincount(seg, minlength=num_segments)[:num_segments]
    starts = torch.cumsum(counts, 0) - counts
    lo_idx = (starts + torch.clamp_min(counts - 1, 0) // 2).clamp(0, n - 1)
    hi_idx = (starts + counts // 2).clamp(0, n - 1)
    meds = []
    for ch in range(values.shape[1]):
        v = values[:, ch]
        order1 = torch.argsort(v, stable=True)
        order2 = torch.argsort(seg[order1], stable=True)
        sv = v[order1[order2]]     # grouped by segment, ascending within
        med = 0.5 * (sv[lo_idx] + sv[hi_idx])
        meds.append(torch.where(counts > 0, med, 0.0))
    return torch.stack(meds, dim=-1)


def image_gradient_sum(channel):
    """``np.sum(np.gradient(ch), axis=0)``: central differences inside,
    one-sided at the borders, summed over both axes."""
    gy, gx = torch.gradient(channel)
    return gy + gx


def _reduce_sums(data_hw_f, seg_ids, num_segments, grid_ctx):
    """(K, F) sums of (H, W, F) data: the grid reduce when a SLIC grid
    context is given, ``index_add_`` otherwise."""
    if grid_ctx is not None:
        from pyimsegm_tpu_torch.ops.grid import grid_segment_sum
        labels2d, cfg = grid_ctx
        return grid_segment_sum(data_hw_f, labels2d, cfg)
    flat = data_hw_f.to(torch.float32).reshape(-1, data_hw_f.shape[-1])
    return _segment_sum(flat, seg_ids, num_segments)


def compute_channel_statistics(image, seg_ids, num_segments, feature_flags,
                               grad_image=None, grid_ctx=None):
    """All selected statistics of an (H, W, C) image over a label map.

    :param image: (H, W, C) float
    :param seg_ids: (H*W,) flat integer labels
    :param feature_flags: subset of ('mean','std','energy','median','meanGrad')
    :param grad_image: optional precomputed gradient image (H, W, C)
    :param grid_ctx: optional (labels2d, SlicConfig) of grid-structured
        labels, which take the grid reduce
    :returns: (num_segments, C * n_flags), stat-major: all channels of
        'mean', then all of 'std', ...
    """
    h, w, c = image.shape
    image = image.to(torch.float32)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=image.device)
    blocks = {}
    if any(f in feature_flags for f in ('mean', 'std', 'energy')):
        sums = _reduce_sums(torch.cat([image, image * image, ones], -1),
                            seg_ids, num_segments, grid_ctx)
        blocks.update(moment_blocks(sums[:, :-1], sums[:, -1]))
    if 'median' in feature_flags:
        blocks['median'] = segment_median(image.reshape(-1, c), seg_ids,
                                          num_segments)
    if 'meanGrad' in feature_flags:
        if grad_image is None:
            grad_image = torch.stack(
                [image_gradient_sum(image[..., i]) for i in range(c)], dim=-1)
        gsum = _reduce_sums(torch.cat([grad_image.to(torch.float32), ones], -1),
                            seg_ids, num_segments, grid_ctx)
        blocks['meanGrad'] = gsum[:, :c] / torch.clamp_min(gsum[:, -1:], 1.0)
    return torch.cat([blocks[f] for f in NAMES_FEATURE_FLAGS
                      if f in feature_flags], dim=-1)


def statistic_names(ch_names, feature_flags):
    """Feature names ``<channel>_<flag>``, stat-major."""
    return ['%s_%s' % (n, flag) for flag in NAMES_FEATURE_FLAGS
            if flag in feature_flags for n in ch_names]
