"""Stage breakdown and device trace of the PyTorch port's main path on a GPU.

Drives ``segment_color2d_slic_features_model_graphcut(..., connectivity=False)``
stage by stage on synthetic 884x1200 images (sp_size 35, regul 0.2,
gc_regul 2.0, the GMM of ``tests/data/torch_port_fixture.npz``) and prints:

* warm host-clock ms per stage (each stage ends in a synchronize);
* from ``torch.profiler`` over one warm image: the device time summed over
  kernels, the wall time, the device idle share, the launch count and the
  top kernels by device time.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/profile_torch_port.py --out DIR [--images 5]

The chrome trace goes to ``<out>/torch_port_trace.json``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (884, 1200)
SP_SIZE, SP_REGUL, GC_REGUL = 35, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}


def _stages(torch, image, model):
    """One image through the path, stage by stage; {stage: ms}."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.ops import graphcut
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops.grid import grid_lookup

    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    spec = pipelines._features_spec(FEATURES)
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    img = stage('upload', lambda: torch.as_tensor(image, device='cuda'))
    labels, features, _, centers = stage(
        'slic_features', lambda: pipelines._slic_features_core(
            img, cfg, spec, m, connectivity=False))
    proba = stage('predict_proba', lambda: model.predict_proba(features))
    soft = stage('lookup_proba', lambda: grid_lookup(proba, labels, cfg))
    graph = stage('mrf', lambda: graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=img, features=features,
        gc_regul=GC_REGUL, grid_ctx=(labels, cfg), centers=centers))
    segm = stage('lookup_labels', lambda: grid_lookup(graph, labels, cfg))
    stage('fetch', lambda: (segm.cpu().numpy(), soft.cpu().numpy()))
    return times


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--images', type=int, default=5)
    parser.add_argument('--out', required=True,
                        help='directory for the trace and the op table')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_port: no CUDA device')
    sys.path.insert(0, ROOT)
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment)

    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip())
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture.npz')) as npz:
        model = class_model_from_numpy(
            {k: npz[k] for k in npz.files}).to('cuda')
    images = [sample_color_image_rand_segment(CROP, 3, rand_seed=s)[0]
              for s in range(args.images)]

    _stages(torch, images[0], model)                       # build + warm
    rows = [_stages(torch, img, model) for img in images]
    names = list(rows[0])
    mean = {n: float(np.mean([r[n] for r in rows])) for n in names}
    print('stage ms (mean of %d warm images): %s' % (len(rows),
                                                     json.dumps(mean)))
    print('stage sum ms: %.3f' % sum(mean.values()))

    def segment():
        return pipelines.segment_color2d_slic_features_model_graphcut(
            images[0], model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, connectivity=False)

    segment()
    torch.cuda.synchronize()
    walls = []
    for img in images:
        t0 = time.perf_counter()
        pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, connectivity=False)
        walls.append((time.perf_counter() - t0) * 1e3)
    print('public call ms per image (same images, same process): %s'
          % json.dumps(walls))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        segment()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print('profiled image: wall %.3f ms, device busy %.3f ms, idle share '
          '%.4f, %d kernel launches' % (wall, device_ms,
                                        1.0 - device_ms / wall, launches))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print('  %-60s %8.3f ms %5d calls' % (e.key[:60],
                                              e.self_device_time_total / 1e3,
                                              e.count))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, 'torch_port_trace.json'))
    with open(os.path.join(args.out, 'torch_port_profile.txt'), 'w') as fh:
        fh.write(prof.key_averages().table(row_limit=40))


if __name__ == '__main__':
    main()
