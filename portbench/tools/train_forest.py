"""Fit the forest of the ``sup_texture`` configuration and write it to the
configuration's ``forest_file``.

    python3 portbench/tools/train_forest.py [--device cuda]

The training tile is drawn by the cell's own generator from a seed that no
run uses; its superpixels and features come from the plain reference
(``portbench/reference``), each superpixel takes the class that covers at
least 90% of it (others are dropped), and the forest is the port's
extra-trees fit as frozen in ``portbench/reference/frozen/models/forest.py``
(32 trees of depth 8, 8 candidate splits, Poisson bagging, a generator
seeded 0), on features standardised by their mean and deviation.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

#: run seeds are drawn below 2**63; training tiles come from these
TRAIN_SEEDS = (2 ** 63 + 1,)
PURITY = 0.9


def main():
    import numpy as np
    import torch

    from portbench.reference.frozen.models import forest as forest_mod
    from portbench.reference import sup2d
    from portbench.reference.precision import precision
    from portbench.traffic import generate

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    with open(os.path.join(ROOT, 'portbench/configs/sup_texture.json')) as fh:
        config = json.load(fh)
    with open(os.path.join(ROOT, 'portbench/traffic/tile2048x3600.json')) as fh:
        mix = json.load(fh)
    xs, ys = [], []
    with precision('float32', args.device):
        for seed in TRAIN_SEEDS:
            image, truth = generate.make_item(mix, seed, 0, args.device)
            labels = sup2d.labels_of(image, config)
            features, _ = sup2d.features_of(image, labels, config)
            k, c = features.shape[0], len(mix['classes'])
            hist = torch.zeros((k, c), dtype=torch.float64,
                               device=labels.device)
            hist.index_put_((labels.reshape(-1).long(),
                             truth.reshape(-1).long()),
                            torch.ones((), dtype=torch.float64,
                                       device=labels.device),
                            accumulate=True)
            frac = hist / hist.sum(1, keepdim=True).clamp_min(1)
            keep = frac.max(1).values >= PURITY
            xs.append(torch.nan_to_num(features[keep]).cpu().numpy())
            ys.append(frac.argmax(1)[keep].cpu().numpy())
            print('seed %d: %d of %d superpixels kept' % (seed, int(keep.sum()),
                                                         k), flush=True)
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int64)
    mu, sd = x.mean(0), x.std(0) + 1e-12
    gen = torch.Generator().manual_seed(0)
    params = forest_mod.forest_fit(
        gen, torch.as_tensor((x - mu) / sd), torch.as_tensor(y),
        torch.ones(len(y)), c, n_trees=32, depth=8, n_candidates=8)
    proba = forest_mod._forest_predict(params.feat, params.thr,
                                       params.leaf_proba, params.depth,
                                       torch.as_tensor((x - mu) / sd))
    print('training accuracy %.4f' % float(
        (proba.argmax(1).numpy() == y).mean()), flush=True)
    out = os.path.join(ROOT, config['forest_file'])
    np.savez_compressed(
        out, classes=np.arange(c), scaler_mean=mu.astype(np.float32),
        scaler_std=sd.astype(np.float32),
        feat=params.feat.numpy().astype(np.int32),
        thr=params.thr.numpy().astype(np.float32),
        leaf_proba=params.leaf_proba.numpy().astype(np.float32),
        depth=np.int32(params.depth))
    print('wrote %s (%d bytes)' % (out, os.path.getsize(out)))


if __name__ == '__main__':
    main()
