"""The yardstick's peaks and work counts.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W (dense
rates): HBM at 3.35 TB/s and float32 outside the tensor cores at 67
TFLOP/s; the port runs float32 with TF32 off.  A share of a peak is stated
against these numbers, with the card's power limit beside it.

The work counts are copies of ``chip_smoke.py``'s per-kernel counts: bytes
read and written once, and f32 operations without FMA, from the item's
shape alone, so they read the same work whatever implements a stage later.
"""

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations per candidate of a SLIC distance, no FMA: 2D colour
#: 3 sub + 3 mul + 2 add, spatial 2 sub + 2 mul + 1 add, weighting 2 mul +
#: 1 add, compare 1; 3D the same with one colour channel and three axes
SLIC_OPS_2D = SLIC_OPS_3D = 17
#: iterations of the SLIC schedule (skimage's ``max_num_iter``)
SLIC_ITERS = 10


def least_ms(nbytes, ops):
    """max(bytes / HBM rate, ops / f32 peak) in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def grid2d(height, width, sp_size):
    """(pixels, padded pixels, seeds) of the 2D seed grid."""
    step = max(2, int(sp_size))
    gh, gw = math.ceil(height / step), math.ceil(width / step)
    return height * width, gh * step * gw * step, gh * gw


def grid3d(shape, sp_size, spacing):
    """(voxels, padded voxels, seeds) of the 3D seed grid."""
    mn = min(float(s) for s in spacing)
    steps = [max(1, int(round(sp_size * mn / float(s)))) for s in spacing]
    grid = [max(1, math.ceil(d / st)) for d, st in zip(shape, steps)]
    pad = [g * st for g, st in zip(grid, steps)]
    return (math.prod(shape), math.prod(pad), math.prod(grid))


def slic2d_rows(height, width, sp_size):
    """{row: (bytes, ops)} of rows 1 (blur_lab), 2 (slic_multi_update, the
    9-round update schedule) and 4 (slic_assign, the final labels)."""
    px, ppx, k = grid2d(height, width, sp_size)
    n_upd = SLIC_ITERS - 1
    return {
        # f32 RGB in, bf16 Lab out; 2 x 3 x 17 blur taps, 6 for the
        # rescale, ~57 for sRGB -> XYZ -> Lab
        1: (px * (12 + 6), px * (102 + 6 + 57)),
        # bf16 Lab in, centres in and out; per round and pixel 9 candidate
        # distances and 6 pooled sums
        2: (ppx * 6 + 2 * k * 5 * 4, n_upd * ppx * (9 * SLIC_OPS_2D + 6)),
        # bf16 Lab in, i32 labels out; 9 distances per pixel
        4: (ppx * (6 + 4) + k * 6 * 4, ppx * 9 * SLIC_OPS_2D),
    }


def slic3d_row15(shape, sp_size, spacing):
    """(bytes, ops) of row 15 (slic3d_iterate, the 10-iteration schedule)."""
    n_vox, pvox, k = grid3d(shape, sp_size, spacing)
    n = SLIC_ITERS
    # f32 padded volume + seeds in, i32 labels out; 9 partials passes,
    # 9 updates (27 x 5 adds + 4 divisions per seed) and a labels pass
    return (pvox * (4 + 4) + k * 16,
            n * pvox * 27 * SLIC_OPS_3D + (n - 1) * (n_vox * 5 + k * (135 + 4)))


#: filters of the Leung-Malik banks: per sigma an edge and a bar filter at
#: each orientation, a Gaussian and two Laplacians of Gaussian; 'tLM' has 4
#: sigmas and 8 orientations, 'tLM_short' 3 sigmas and 4 orientations
LM_FILTERS = {'tLM': 4 * (2 * 8 + 3), 'tLM_short': 3 * (2 * 4 + 3)}


def lm_bank_ops(height, width, filters, channels=3, support=33):
    """f32 operations of an LM bank's convolutions (``filters`` of 33 x 33
    taps on every channel): a multiply and an add per tap."""
    return 2 * height * width * channels * filters * support * support


def slic_work(config, mix):
    """(bytes, ops) of one item's SLIC stage."""
    if config['driver'] == 'gray3d_unsup':
        return slic3d_row15(mix['shape'], config['sp_size'],
                            config['spacing'])
    rows = slic2d_rows(mix['shape'][0], mix['shape'][1], config['sp_size'])
    return (sum(b for b, _ in rows.values()), sum(o for _, o in rows.values()))


def step_ops(config, mix):
    """Counted f32 operations of one item: the SLIC stage, and in 2D the LM
    banks' convolutions.  The features' reductions, the model and the MRF
    are not counted, so a share of the peak from it is a lower bound of
    the step's."""
    ops = slic_work(config, mix)[1]
    if config['driver'] != 'gray3d_unsup':
        for key in config.get('dict_features', {}):
            if key in LM_FILTERS:
                ops += lm_bank_ops(mix['shape'][0], mix['shape'][1],
                                   LM_FILTERS[key])
    return ops
