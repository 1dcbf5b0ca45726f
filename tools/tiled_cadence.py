#!/usr/bin/env python3
"""How often the row-sharded enforcement reads its "changed" flag, on a GPU.

``parallel/tiled.py``'s reach and absorb loops stop once a step changes
nothing on any rank; reading the all-reduced flag is a host
synchronisation, so the loops read it every ``tiled.CHECK_EVERY`` steps
(a step after convergence changes nothing, so every cadence gives the same
labels, and running each loop to its cap does too).  This script runs the
tiled pipeline on the 4096 x 4096 synthetic tile of ``chip_smoke.py``
(sp_size 35, regul 0.2, gc_regul 2.0, 3 classes, a world of one) with each
cadence of ``--every`` (0 runs both loops to their caps, 4 * step and 2 *
step) and prints, per cadence: the boundary-row exchanges of one call
(steps of both loops, plus the two single exchanges), the best warm ms of
three calls, the device ms of the ``enforce`` stage, the CUDA kernels
and device busy ms of one profiled call, and whether the maps equal the
first cadence's.  Run from the root of a checkout::

    python3 tools/tiled_cadence.py [--every 4,1,8,16,0,4]
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--every', default='4,1,8,16,0,4',
                        help='comma-separated cadences; 0 = run to the cap')
    args = parser.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as smoke
    from pyimsegm_tpu_torch.parallel import batch, tiled
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mesh = batch.make_mesh(axis_name='rows')
    tile = sample_color_image_rand_segment(smoke.TILE_13, 3, rand_seed=1)[0]
    exchanges = [0]
    row_exchange = tiled._row_exchange

    def counted(*a, **k):
        exchanges[0] += 1
        return row_exchange(*a, **k)

    tiled._row_exchange = counted

    def pipe():
        return tiled.pipe_color2d_slic_features_model_graphcut_tiled(
            tile, smoke.NB_CLASSES, smoke.FEATURES, sp_size=smoke.SP_SIZE,
            sp_regul=smoke.SP_REGUL, gc_regul=smoke.GC_REGUL, mesh=mesh)

    first = None
    try:
        for every in (int(e) for e in args.every.split(',')):
            tiled.CHECK_EVERY = every if every > 0 else 10 ** 9
            exchanges[0] = 0
            out = pipe()
            steps = exchanges[0]
            ms = min(smoke._warm_ms(torch, pipe, 1) for _ in range(3))
            stages, busy, kernels = smoke._stage_device_ms(torch, pipe)
            first = first or out
            print(json.dumps(dict(
                check_every=every or 'cap', row_exchanges=steps,
                warm_ms=round(ms, 3),
                enforce_device_ms=round(stages.get('enforce', -1.0), 3),
                kernels=kernels, busy_ms=round(busy, 3),
                same_as_first=bool(np.array_equal(out[0], first[0])
                                   and np.array_equal(out[1], first[1])))),
                flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
