"""Hold the grid kernels of two checkouts to equal bits on the card.

Rows 6 (``grid_reduce``, f32 and bf16), 7 (``grid_moments_apply`` without a
donor table), 10 (``grid_pair_count`` and ``counts_and_contacts``) and 11
(the presence words and the routed adjacency) at F = 1, 3, 4, 7, 30 and 60,
on the SLIC kernels' labels at 884x1200 and 883x1197 (sp_size 35: one band
a tile) and on numpy grid labels at seed steps 129 (300x700) and 1024
(1100x2100), where a tile takes several bands.  One run saves its outputs,
a second run with another checkout's package compares, printing the outputs
whose bits differ and by how much.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/compare_grid_bits.py save --out FILE
    python3 tools/compare_grid_bits.py compare --root CHECKOUT --out FILE
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (shape, sp_size): one band a tile at 35, several at 129 and 1024
CASES = (((884, 1200), 35), ((883, 1197), 35), ((300, 700), 129),
         ((1100, 2100), 1024))


def _grid_labels(torch, cfg, seed):
    """Each 5x5 block of pixels takes its tile's seed moved by -1..1."""
    h, w, step = cfg.height, cfg.width, cfg.step
    rng = np.random.default_rng(seed)
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    moves = rng.integers(-1, 2, (2, (h + 4) // 5, (w + 4) // 5))
    sy = np.clip(y // step + moves[0][y // 5, x // 5], 0, cfg.grid_h - 1)
    sx = np.clip(x // step + moves[1][y // 5, x // 5], 0, cfg.grid_w - 1)
    return torch.as_tensor((sy * cfg.grid_w + sx).astype(np.int32),
                           device='cuda')


def outputs(torch):
    """{name: CPU tensor} of every kernel output on every case."""
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    out = {}
    for shape, sp in CASES:
        cfg = slic_ops.slic_config(shape[0], shape[1], sp)
        if sp == 35:
            img = torch.as_tensor(sample_color_image_rand_segment(
                shape, 3, rand_seed=0)[0], device='cuda')
            m = slic_ops.compactness_from_regul(sp, 0.2)
            lab = slic_ops.slic_segment_with_features(img, img, cfg,
                                                      m)[0].contiguous()
        else:
            lab = _grid_labels(torch, cfg, seed=1)
        rng = np.random.default_rng(2)
        key = '%dx%d step %d ' % (shape + (sp,))
        for f in (1, 3, 4, 7, 30, 60):
            d = torch.as_tensor(rng.normal(size=shape + (f,)).astype(
                np.float32), device='cuda')
            out[key + 'row 6 F=%d' % f] = grid_cuda.grid_reduce(d, lab, cfg)
            out[key + 'row 6 bf16 F=%d' % f] = grid_cuda.grid_reduce(
                d.bfloat16(), lab, cfg)
            out[key + 'row 7 F=%d' % f] = grid_cuda.grid_moments_apply(
                d, lab, None, cfg)[1]
        for i, t in enumerate(grid_cuda.counts_and_contacts(lab, cfg)):
            out[key + 'row 10 routed %d' % i] = t
        for i, t in enumerate(grid_cuda.grid_pair_count(lab, cfg)):
            out[key + 'row 10 pass %d' % i] = t
        out[key + 'row 11 words'] = grid_cuda.grid_adjacency_presence(lab,
                                                                      cfg)
        out[key + 'row 11 adjacency'] = grid_ops.grid_adjacency(lab, cfg)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('mode', choices=('save', 'compare'))
    parser.add_argument('--root', default=ROOT,
                        help='checkout whose package runs')
    parser.add_argument('--out', required=True,
                        help='file of the saved outputs')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('compare_grid_bits: no CUDA device')
    sys.path.insert(0, os.path.abspath(args.root))
    got = outputs(torch)
    if args.mode == 'save':
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save(got, args.out)
        print('saved %d outputs of %s' % (len(got), args.root))
        return
    saved = torch.load(args.out)
    differ = {k: float((got[k].float() - saved[k].float()).abs().max())
              for k in got if not torch.equal(got[k], saved[k])}
    print('%s against the saved outputs: %d of %d with equal bits'
          % (args.root, len(got) - len(differ), len(got)))
    for k, v in differ.items():
        print('  differs: %s (max abs diff %g)' % (k, v))


if __name__ == '__main__':
    main()
