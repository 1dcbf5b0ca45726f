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
* one warm batch call of one image traced as the benchmark traces its
  cells (``portbench.trace``, see below).

Every traced window is reduced by ``portbench.trace.summarise``, the
benchmark's reduction, and printed as one JSON object of figures per
input: the window's ms, device busy ms and idle share (no kernel, copy or
memset running, from device timestamps), per ``pyimsegm:<stage>`` range
its count, host ms, busy ms (the kernels launched in it, innermost range
first) and kernels, ``gather_ms`` and the EM readers of
``portbench/metrics/`` where the path has them, the program's counters of
the window (``utils.device.counters``: the EM counters, among them
``em_kernel_runs``, the fits whose products ran on ``csrc/gmm_em.cu``, and
``filter_bank_launches`` on the paths with a texture bank), the top
kernels and the idle gaps
by range; the chrome trace goes to ``<out>/torch_port_trace_<kind>.json``.

``--path fit`` drives the unsupervised fit path
(``pipe_color2d_slic_features_model_graphcut`` with the full colour feature
set and a GMM fitted on each image) on the synthetic scenes, stage by stage
(upload, SLIC, enforcement, geometry, statistics, median, fit,
predict_proba, MRF, fetch), and profiles one warm call the same way.

``--path 3d`` drives the 3D gray-volume path
(``pipe_gray3d_slic_features_model_graphcut`` at the repo's 3D workload:
48x640x768, spacing (4, 1, 1), sp_size 15, regul 0.2, gc_regul 0.1, mean /
std / energy, a 2-class GMM fitted on the volume) on the structured volumes
of ``sample_gray_volume_3d`` (seeds 0, 1, ...).  Its stages (upload, slic,
counts, features, fit, predict_proba, edges, mrf, lookup, fetch) are the
``pyimsegm:<stage>`` profiler ranges that the pipeline itself opens: each
warm call's host-clock ms, then every input in one traced window, reduced
as above.

``--path 3d_tlm`` does the same with LM texture beside the intensity
statistics (colour mean / std / energy and ``tLM`` mean, 23 features,
as ``chip_smoke.py`` drives it), the bank's convolution in its features
stage.

``--path sup`` drives the supervised path (BASELINE config 2:
``segment_color2d_slic_features_model_graphcut`` with colour + tGabor +
tLBP features, gc_regul 5.0, the JAX-trained forest of
``tests/data/torch_port_fixture_sup.npz``) on the synthetic scenes at
884x1200 and on one 2048x3600 and one 4096x4096 tile (rows 14 and 13 of
the enforcement); its stages (upload, slic, enforce, geometry, features,
predict_proba, edges, mrf, fetch) are the pipeline's own ``pyimsegm:``
ranges, read as for ``--path 3d``.

``--path centers`` drives the fused centre detection of BASELINE config 4
(``centers.load_compute_detect_centers`` with the JAX-trained forest of
``tests/data/torch_port_fixture_centers.npz``) on 647x1024 synthetic
ovary scenes (``sample_ovary_scene``, seeds 3, 4, ...); its stages (slic,
enforce, geometry, hist, rays, shift, classify, cluster) are the chain's
own ``pyimsegm:`` ranges, read as for ``--path 3d``.

``--path rg2sp`` drives BASELINE config 5 (the SLIC of
``superpixels.segment_slic_img2d`` at sp_size 15, then GraphCut RG2Sp with
the JAX-fitted shape model of ``tests/data/torch_port_fixture_rg2sp.npz``,
up to 100 rounds) on 647x1024 ovary scenes (seeds 3, 10, 11, ...: seed
3's labels take the edge-list solve, the others the grid solve); its
stages (slic, then per round upload, candidates, shape_update, unary,
solve, fetch) are the region growing's own ``pyimsegm:`` ranges, read as
for ``--path 3d``, with the rounds of each call.

``--path kernels`` measures kernel rows 1 (as ``_prepare_chw`` calls it,
with its host-to-device copies), 2 (plain and SLICO), 3 (with its routing
to per-seed sums), 4 (plain and SLICO), 5, 8, 9, 10 (as the bench path's
``counts_and_contacts``, with its routing), 11 (as the edge weights'
``grid_adjacency``, with its routing, on the enforced labels) and 12 and
the bench path's whole SLIC stage as the paths call them, on image 0 and on
the first noise image, rows 6 (F = 7 f32 and bf16, F = 4 f32, F = 30
bf16) and 7 (F = 3, 18, 60) on image 0, and row 15 (the 10-iteration schedule and its
two passes) at the 3D workload (``chip_smoke.measure_path_kernels``: call
ms, device ms and CUDA kernel launches per call), with the package of the
checkout at ``--root`` (this one by default), so that one call on the card
can measure two checkouts in turns (``chip_smoke.py`` prints the launches
of rows 6 and 7 by F on the paths it drives).

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/profile_torch_port.py --out DIR [--images 4] \
        [--path bench|fit|3d|3d_tlm|sup|centers|rg2sp|kernels]
        [--root CHECKOUT]
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
SHAPE_3D, SPACING_3D, SP_3D, REGUL_3D, GC_REGUL_3D = \
    (48, 640, 768), (4, 1, 1), 15, 0.2, 0.1
FEATURES_SUP = {'color': ['mean', 'std', 'energy'],
                'tGabor': ['mean', 'energy'], 'tLBP': ['mean']}
GC_REGUL_SUP = 5.0
TILES = ((2048, 3600), (4096, 4096))
FEATURES_3D_TLM = {'color': ['mean', 'std', 'energy'], 'tLM': ['mean']}
OVARY = (647, 1024)


def _stages(torch, image, model):
    """One image through the bench path, stage by stage; {stage: ms}."""
    from pyimsegm_tpu_torch.ops import graphcut, segment_stats
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
        return segment_stats.moment_features(sums[:, :6], counts,
                                             flags), cen
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


def _reduce(s, counters):
    """A JSON-ready dict of one traced window's summary ``s``
    (``portbench.trace.summarise``, the benchmark's reduction): the window,
    device busy ms and idle share, and per ``pyimsegm:<stage>`` range its
    count, host ms, busy ms and kernels a traced item; ``gather_ms`` and
    the EM readers as ``portbench/metrics/`` reads them (for the stages the
    trace holds; a reading the trace lacks says so); and the program's
    counters of the window."""
    from portbench import trace as tr
    from portbench.metrics import em_iters, em_useful_share, gather_ms
    n = s['items']
    ctx = {'summary': s, 'config': {'stages': list(s['stages'])},
           'counters': counters}
    out = {'items': n, 'window_ms': s['window_us'] / 1e3 / n,
           'busy_ms': s['busy_us'] / 1e3 / n,
           'device_idle_share': 100.0 * (1.0 - s['busy_us']
                                         / s['window_us']),
           'stages': {k: {'count': v['count'] / n,
                          'host_ms': v['host_us'] / 1e3 / n,
                          'busy_ms': v['busy_us'] / 1e3 / n,
                          'kernels': v['kernels'] / n}
                      for k, v in sorted(s['stages'].items())},
           'counters': counters,
           'device_ops': tr.top(s['device_ops'], 15),
           'idle_gaps': tr.top(s['idle_by_range'])}
    for name, mod in (('gather_ms', gather_ms), ('em_iters', em_iters),
                      ('em_useful_share', em_useful_share)):
        try:
            value = mod.read(ctx)
        except tr.TraceError as err:
            value = 'not read: %s' % err
        if value is not None:
            out[name] = value
    return out


def _traced(run, inputs, out_dir, kind):
    """``run`` on each input under the profiler, each in a
    ``portbench:item`` range (``portbench.trace.profile_items``); prints
    the window's reduction and writes its chrome trace to ``out_dir``."""
    from portbench import trace as tr
    from pyimsegm_tpu_torch.utils import device
    device.reset_counters()
    events = tr.profile_items(run, inputs)
    red = _reduce(tr.summarise(events), device.counters())
    print('%s traced (%d inputs, per input): %s'
          % (kind, len(inputs), json.dumps(red)))
    with open(os.path.join(out_dir, 'torch_port_trace_%s.json' % kind),
              'w') as fh:
        json.dump({'traceEvents': events}, fh)


def _profile_ranges(torch, run, inputs, out_dir, kind):
    """The public call on each input on the host clock, then all inputs in
    one traced window, reduced as the benchmark reduces its traces."""
    run(inputs[0])                                         # build + warm
    walls = [_timed(torch, lambda: run(x)) for x in inputs]
    print('%s call ms per input (host clock): %s'
          % (kind, json.dumps([round(w, 3) for w in walls])))
    _traced(run, inputs, out_dir, kind)


def _profile_gray3d(torch, volumes, out_dir, features, kind):
    from pyimsegm_tpu_torch import pipelines

    def run(vol):
        return pipelines.pipe_gray3d_slic_features_model_graphcut(
            vol, 2, features, spacing=SPACING_3D, sp_size=SP_3D,
            sp_regul=REGUL_3D, gc_regul=GC_REGUL_3D)

    _profile_ranges(torch, run, volumes, out_dir, kind)


def _profile_sup(torch, images, out_dir):
    """Config 2 with the carried JAX forest on the scenes, then one call of
    each tile."""
    from pyimsegm_tpu_torch import classification, pipelines
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture_sup.npz')) as npz:
        clf = classification.classifier_from_numpy(
            {k[len('clf_'):]: npz[k] for k in npz.files
             if k.startswith('clf_') and not k.endswith('_tlm')})

    def run(img):
        return pipelines.segment_color2d_slic_features_model_graphcut(
            img, clf, FEATURES_SUP, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL_SUP)

    _profile_ranges(torch, run, images, out_dir, 'sup')
    for shape in TILES:
        tile = sample_color_image_rand_segment(shape, 3, rand_seed=1)[0]
        _profile_ranges(torch, run, [tile], out_dir,
                        'sup_%dx%d' % shape)


def _profile_centers(torch, n_images, out_dir):
    """The fused centre detection with the carried forest on the ovary
    scenes."""
    from pyimsegm_tpu_torch import centers
    from pyimsegm_tpu_torch.classification import classifier_from_numpy
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture_centers.npz')) as npz:
        clf = classifier_from_numpy({k[len('clf_'):]: npz[k]
                                     for k in npz.files
                                     if k.startswith('clf_')})
    scenes = [sample_ovary_scene(OVARY, 4, rand_seed=3 + s)[:2]
              for s in range(n_images)]

    def run(scene):
        return centers.load_compute_detect_centers(scene[0], scene[1], clf)

    _profile_ranges(torch, run, scenes, out_dir, 'centers')


def _profile_rg2sp(torch, n_images, out_dir):
    """Config 5 with the carried shape model on the ovary scenes."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch import superpixels
    from pyimsegm_tpu_torch.ops.slic import slic_config
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    from pyimsegm_tpu_torch.utils.device import stage_range
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture_rg2sp.npz')) as npz:
        model = rg.shape_model_from_numpy(
            {k[len('shape_'):]: npz[k] for k in npz.files
             if k.startswith('shape_')}, device='cuda')
    cfg = slic_config(OVARY[0], OVARY[1], 15)
    scenes = [sample_ovary_scene(OVARY, 4, rand_seed=s)
              for s in (3, 10, 11, 12, 13)[:n_images]]
    rounds = []

    def run(scene):
        img, segm, centres = scene
        with stage_range('slic'):
            slic = superpixels.segment_slic_img2d(img, sp_size=15,
                                                  relative_compact=0.2)
        prob = rg.compute_segm_prob_fg(slic, segm,
                                       [0.1, 0.9, 0.75, 0.9, 0.9])
        hist = {}
        rg.region_growing_shape_slic_graphcut(
            slic, prob, centres, model, 'cdf', coef_shape=5.,
            coef_pairwise=15., prob_label_trans=[0.1, 0.03],
            optim_global=True, nb_iter=100, debug_history=hist,
            grid_cfg=cfg)
        rounds.append((int(slic.max()) + 1, len(hist['labels'])))

    _profile_ranges(torch, run, scenes, out_dir, 'rg2sp')
    print('rg2sp (K, rounds) of each call, in order: %s' % rounds)


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
    """One call in a traced window, reduced as the benchmark reduces its
    traces."""
    _traced(lambda _: run(), [None], out_dir, kind)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--images', type=int, default=4)
    parser.add_argument('--path', choices=('bench', 'fit', '3d', '3d_tlm',
                                           'sup', 'centers', 'rg2sp',
                                           'kernels'),
                        default='bench')
    parser.add_argument('--out', required=True,
                        help='directory for the traces and the op tables')
    parser.add_argument('--root', default=ROOT,
                        help='checkout whose package is measured')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('profile_torch_port: no CUDA device')
    sys.path.insert(0, os.path.abspath(args.root))
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.parallel import batch
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment, sample_gray_volume_3d)

    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip())
    sys.path.append(ROOT)                                  # portbench
    if args.path == 'kernels':
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        print('package of %s' % os.path.abspath(args.root))
        chip_smoke.measure_path_kernels(torch, torch.as_tensor(
            sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
            device='cuda'))
        return
    os.makedirs(args.out, exist_ok=True)
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture.npz')) as npz:
        model = class_model_from_numpy(
            {k: npz[k] for k in npz.files}).to('cuda')
    if args.path in ('3d', '3d_tlm'):
        _profile_gray3d(torch, [sample_gray_volume_3d(SHAPE_3D, rand_seed=s)[0]
                                for s in range(args.images)], args.out,
                        FEATURES_3D_TLM if args.path == '3d_tlm' else FEATURES,
                        args.path)
        return
    if args.path == 'centers':
        _profile_centers(torch, args.images, args.out)
        return
    if args.path == 'rg2sp':
        _profile_rg2sp(torch, args.images, args.out)
        return
    if args.path == 'sup':
        _profile_sup(torch, [sample_color_image_rand_segment(
            CROP, 3, rand_seed=s)[0] for s in range(args.images)], args.out)
        return
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
