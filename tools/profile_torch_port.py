"""Stage breakdown and device trace of the PyTorch port on a GPU.

``--path bench`` (the default) drives the bench path (``parallel.batch.segment_images_batch``: SLIC,
connectivity enforcement, min-size merge with the moments re-reduce, GMM
predict, grid MRF, one fused lookup) stage by stage on 884x1200 images
(sp_size 35, regul 0.2, gc_regul 2.0, the GMM of
``tests/data/torch_port_fixture.npz``), on two kinds of image: the
synthetic scenes of ``sample_color_image_rand_segment`` and the uniform
noise of ``bench.py``'s fallback, whose fragmented superpixels make the
enforcement do the most work.  Prints:

* warm host-clock ms per stage (each stage ends in a synchronize);
* the batch call's warm ms per image, in turns with the stage runs;
* from ``torch.profiler`` over one warm batch call of one image: the device
  time summed over kernels and copies, the wall time, the device idle
  share, the launch count and the top kernels by device time.

``--path fit`` drives the unsupervised fit path
(``pipe_color2d_slic_features_model_graphcut`` with the full colour feature
set and a GMM fitted on each image) on the synthetic scenes, stage by stage
(upload, SLIC, enforcement, geometry, statistics, median, fit,
predict_proba, MRF, fetch), and profiles one warm call the same way.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/profile_torch_port.py --out DIR [--images 4] [--path fit]

The chrome trace goes to ``<out>/torch_port_trace_<kind>.json``.
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
FEATURES_FIT = {'color': ['mean', 'std', 'energy', 'median', 'meanGrad']}


def _stages(torch, image, model):
    """One image through the bench path, stage by stage; {stage: ms}."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.ops import graphcut
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops

    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    flags = FEATURES['color']
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    img = stage('upload', lambda: torch.as_tensor(image, device='cuda'))
    labels, _, centers, _ = stage(
        'slic', lambda: slic_ops.slic_segment_with_features(img, img, cfg, m))
    enforced = stage('enforce', lambda: grid_ops.enforce_grid_connectivity(
        labels, cfg, centers=centers))
    counts, sym25, counts9 = stage(
        'minsize_measure', lambda: grid_ops.counts_and_contacts(enforced,
                                                                cfg))
    donor = stage('donor_table', lambda: grid_ops.donor_chain_table(
        counts, sym25, cfg.grid_h, cfg.grid_w, int(0.5 * cfg.step ** 2),
        counts9=counts9))
    labels, sums = stage('apply_moments', lambda: grid_cuda.grid_moments_apply(
        img, enforced, donor, cfg))

    def features():
        counts = sums[:, 6]
        cen = sums[:, 7:9] / torch.clamp_min(counts[:, None], 1.0)
        return pipelines._moment_features(sums[:, :6], counts, flags), cen
    feats, centers = stage('features', features)
    proba = stage('predict_proba', lambda: model.predict_proba(feats))
    graph = stage('mrf', lambda: graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=img, features=feats,
        gc_regul=GC_REGUL, grid_ctx=(labels, cfg), centers=centers))
    up = stage('lookup', lambda: grid_ops.grid_lookup(
        torch.cat([graph[:, None].to(torch.float32), proba], -1), labels,
        cfg))
    stage('fetch', lambda: up.cpu().numpy())
    return times


def _fit_stages(torch, image):
    """One image through the fit path, stage by stage; {stage: ms}."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.models.class_model import estim_class_model
    from pyimsegm_tpu_torch.ops import graphcut, segment_stats
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops

    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    k = cfg.n_segments
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    img = stage('upload', lambda: torch.as_tensor(image, device='cuda'))
    labels = stage('slic', lambda: slic_ops.slic_segment(img, cfg, m))
    labels = stage('enforce', lambda: grid_ops.enforce_grid_connectivity(
        labels, cfg, min_size=int(0.5 * cfg.step ** 2)))
    counts, centers = stage('geometry',
                            lambda: pipelines._grid_geometry(labels, cfg))
    flat, imgf = labels.reshape(-1), img.to(torch.float32)
    stats = stage('statistics', lambda: segment_stats.compute_channel_statistics(
        imgf, flat, k, ('mean', 'std', 'energy', 'meanGrad'),
        grid_ctx=(labels, cfg)))
    med = stage('median', lambda: segment_stats.segment_median(
        imgf.reshape(-1, 3), flat, k))
    feats = torch.cat([stats[:, :9], med, stats[:, 9:]], dim=-1)
    model = stage('fit', lambda: estim_class_model(
        feats, 3, 'GMM', sample_weight=(counts > 0).to(torch.float32)))
    proba = stage('predict_proba', lambda: model.predict_proba(feats))
    graph = stage('mrf', lambda: graphcut.segment_graph_cut_general(
        labels, proba, k, image=img, features=feats, gc_regul=GC_REGUL,
        grid_ctx=(labels, cfg), centers=centers))
    stage('fetch', lambda: pipelines._fetch_reconstruct(labels, proba, graph,
                                                        cfg))
    return times


def _report(kind, rows, walls, n_images):
    names = list(rows[0])
    mean = {n: round(float(np.mean([r[n] for r in rows])), 3) for n in names}
    print('%s stage ms (mean of %d warm images): %s'
          % (kind, len(rows), json.dumps(mean)))
    print('%s stage sum ms: %.3f' % (kind, sum(mean.values())))
    print('%s call ms per image (%d calls of %d, in turns with the stage '
          'runs): %s' % (kind, len(walls), n_images,
                         json.dumps([round(w, 3) for w in walls])))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile_fit(torch, images, out_dir):
    from pyimsegm_tpu_torch import pipelines

    def run(img):
        return pipelines.pipe_color2d_slic_features_model_graphcut(
            img, 3, FEATURES_FIT, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL)

    _fit_stages(torch, images[0])                          # build + warm
    run(images[0])
    rows, walls = [], []
    for img in images:
        rows.append(_fit_stages(torch, img))
        walls.append(_timed(torch, lambda: run(img)))
    _report('fit', rows, walls, 1)
    _profile(torch, lambda: run(images[0]), out_dir, 'fit')


def _profile(torch, run, out_dir, kind):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print('%s profiled one-image call: wall %.3f ms, device busy '
          '%.3f ms, idle share %.4f, %d kernel launches'
          % (kind, wall, device_ms, 1.0 - device_ms / wall, launches))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print('  %-60s %8.3f ms %5d calls' % (e.key[:60],
                                              e.self_device_time_total / 1e3,
                                              e.count))
    prof.export_chrome_trace(os.path.join(out_dir,
                                          'torch_port_trace_%s.json' % kind))
    with open(os.path.join(out_dir, 'torch_port_profile_%s.txt' % kind),
              'w') as fh:
        fh.write(prof.key_averages().table(row_limit=40))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--images', type=int, default=4)
    parser.add_argument('--path', choices=('bench', 'fit'), default='bench')
    parser.add_argument('--out', required=True,
                        help='directory for the traces and the op tables')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_port: no CUDA device')
    sys.path.insert(0, ROOT)
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.parallel import batch
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment)

    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip())
    os.makedirs(args.out, exist_ok=True)
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture.npz')) as npz:
        model = class_model_from_numpy(
            {k: npz[k] for k in npz.files}).to('cuda')
    if args.path == 'fit':
        _profile_fit(torch, [sample_color_image_rand_segment(
            CROP, 3, rand_seed=s)[0] for s in range(args.images)], args.out)
        return
    rng = np.random.default_rng(0)
    kinds = {
        'synthetic': np.stack([sample_color_image_rand_segment(
            CROP, 3, rand_seed=s)[0] for s in range(args.images)]),
        'noise': np.stack([rng.random(CROP + (3,), dtype=np.float32)
                           for _ in range(args.images)]),
    }
    for kind, images in kinds.items():
        def run():
            return batch.segment_images_batch(
                images, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
                gc_regul=GC_REGUL)

        _stages(torch, images[0], model)                   # build + warm
        run()
        rows, walls = [], []
        for img in images:
            rows.append(_stages(torch, img, model))
            walls.append(_timed(torch, run) / len(images))
        _report(kind, rows, walls, len(images))
        _profile(torch, lambda: batch.segment_images_batch(
            images[:1], model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL), args.out, kind)


if __name__ == '__main__':
    main()
