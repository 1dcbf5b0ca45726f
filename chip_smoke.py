#!/usr/bin/env python3
"""On-card check of the PyTorch port (``pyimsegm_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``pyimsegm_tpu_torch/csrc`` (nvcc, at first
   use, into ``build/torch_kernels/``) and print the build seconds;
3. for each of the five kernels, at the bench geometry (884x1200,
   sp_size 35, regul 0.2): kernel and plain PyTorch twin on the same inputs
   on the card, agreement within the stated tolerance, and both times;
4. end to end: three synthetic 884x1200 images through
   ``segment_color2d_slic_features_model_graphcut(..., connectivity=False)``
   with the GMM class model of ``tests/data/torch_port_fixture.npz``; every
   kernel must have launched during that run, and image 0 must agree with
   the stored JAX-CPU result (segmentation ARS >= 0.98, SLIC labels
   >= 0.999); then warm ms per image.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture.npz')
CROP = (884, 1200)
SP_SIZE, SP_REGUL, GC_REGUL = 35, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
REPS = 20
DEVICE = 'cuda'


def _time_ms(fn, reps=REPS):
    """Mean device ms per call, CUDA events around ``reps`` warm calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two bf16 tensors."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _record(name, source, replaces, err, ms, plain_ms, agreement):
    print('kernel %-24s %s  max_abs_err %.3g  kernel %.4f ms  plain %.4f ms'
          % (name, agreement, err, ms, plain_ms), flush=True)
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': 0, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms}


def kernel_phases(torch, img):
    """Each kernel against its plain twin at the bench geometry."""
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda, slic_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops

    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    records = []

    lab_k = prep_cuda.blur_lab(img)
    lab_p = prep_cuda._blur_lab_plain(img)
    torch.cuda.synchronize()
    ulps = _bf16_ulps(lab_k, lab_p)
    equal = float((ulps == 0).float().mean())
    err = float((lab_k.float() - lab_p.float()).abs().max())
    if equal < 0.9999 or int(ulps.max()) > 1:
        raise AssertionError('blur_lab: %.6f equal, max %d ulp'
                             % (equal, int(ulps.max())))
    records.append(_record(
        'blur_lab', 'pyimsegm_tpu_torch/csrc/prep.cu',
        'pyimsegm_tpu/ops/prep_pallas.py:121', err,
        _time_ms(lambda: prep_cuda.blur_lab(img)),
        _time_ms(lambda: prep_cuda._blur_lab_plain(img)),
        'bf16 equal %.6f, max %d ulp' % (equal, int(ulps.max()))))

    lab_chw, centers0 = slic_ops._prepare_chw(img, cfg)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    cen_k = slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg, n_upd)
    cen_p = slic_cuda._slic_multi_update_plain(lab_chw, centers0, m, cfg,
                                               n_upd)
    torch.cuda.synchronize()
    err = float((cen_k - cen_p).abs().max())
    if not err <= 1e-3:
        raise AssertionError('slic_multi_update: centres differ by %g' % err)
    records.append(_record(
        'slic_multi_update', 'pyimsegm_tpu_torch/csrc/slic.cu',
        'pyimsegm_tpu/ops/slic_pallas.py:477', err,
        _time_ms(lambda: slic_cuda.slic_multi_update(
            lab_chw, centers0, m, cfg, n_upd), reps=5),
        _time_ms(lambda: slic_cuda._slic_multi_update_plain(
            lab_chw, centers0, m, cfg, n_upd), reps=5),
        'centres within %.3g (tol 1e-3)' % err))

    feat_chw = torch.zeros((3, cfg.pad_h, cfg.pad_w), dtype=torch.float32,
                           device=img.device)
    feat_chw[:, :cfg.height, :cfg.width] = img.permute(2, 0, 1)
    lb_k, part_k = slic_cuda.slic_update_labels(lab_chw, cen_k, m, cfg,
                                                feat_chw)
    lb_p, part_p = slic_cuda._slic_update_labels_plain(lab_chw, cen_k, m, cfg,
                                                       feat_chw)
    torch.cuda.synchronize()
    lab_eq = float((lb_k == lb_p).float().mean())
    # partial sums are added in another order than the plain twin's: rtol
    # 1e-5, plus 1e-5 of the channel's largest partial for the signed Lab
    # a/b sums, whose relative error is unbounded where they cancel
    diff = (part_k - part_p).abs()
    scale = part_p.abs().amax(dim=(0, 1, 2), keepdim=True)
    ok = diff <= 1e-5 * part_p.abs() + 1e-5 * scale
    err = float(diff.max())
    if lab_eq < 0.999 or not bool(ok.all()):
        raise AssertionError('slic_update_labels: labels %.6f equal, '
                             'partials max diff %g' % (lab_eq, err))
    records.append(_record(
        'slic_update_labels', 'pyimsegm_tpu_torch/csrc/slic.cu',
        'pyimsegm_tpu/ops/slic_pallas.py:573', err,
        _time_ms(lambda: slic_cuda.slic_update_labels(
            lab_chw, cen_k, m, cfg, feat_chw)),
        _time_ms(lambda: slic_cuda._slic_update_labels_plain(
            lab_chw, cen_k, m, cfg, feat_chw)),
        'labels equal %.6f, partials within rtol 1e-5' % lab_eq))

    labels = lb_k[:cfg.height, :cfg.width].contiguous()
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.random((cfg.n_segments, 3), np.float32),
                            device=img.device)
    out_k = grid_cuda.grid_lookup(table, labels, cfg)
    out_p = grid_cuda._grid_lookup_plain(table, labels, cfg)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError('grid_lookup differs by %g' % err)
    records.append(_record(
        'grid_lookup', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:379', err,
        _time_ms(lambda: grid_cuda.grid_lookup(table, labels, cfg)),
        _time_ms(lambda: grid_cuda._grid_lookup_plain(table, labels, cfg)),
        'exact'))

    words_k = grid_cuda.grid_adjacency_presence(labels, cfg)
    words_p = grid_cuda._grid_adjacency_presence_plain(labels, cfg)
    torch.cuda.synchronize()
    if not torch.equal(words_k, words_p):
        raise AssertionError('grid_adjacency_presence: %d words differ'
                             % int((words_k != words_p).sum()))
    records.append(_record(
        'grid_adjacency_presence', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:568', 0.0,
        _time_ms(lambda: grid_cuda.grid_adjacency_presence(labels, cfg)),
        _time_ms(lambda: grid_cuda._grid_adjacency_presence_plain(labels,
                                                                  cfg)),
        'exact'))
    return records


def _counters():
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda, slic_cuda
    return {'blur_lab': prep_cuda.LAUNCHES,
            'slic_multi_update': slic_cuda.LAUNCHES['slic_multi_update'],
            'slic_update_labels': slic_cuda.LAUNCHES['slic_update_labels'],
            'grid_lookup': grid_cuda.LAUNCHES['grid_lookup'],
            'grid_adjacency_presence':
                grid_cuda.LAUNCHES['grid_adjacency_presence']}


def _reset_counters():
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda, slic_cuda
    prep_cuda.LAUNCHES = 0
    for counts in (slic_cuda.LAUNCHES, grid_cuda.LAUNCHES):
        for key in counts:
            counts[key] = 0


def end_to_end(torch, fixture):
    """The port's main path on three 884x1200 images; returns the launch
    counts of the first pass and the warm ms per image."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment)
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

    model = class_model_from_numpy(fixture).to(DEVICE)
    images = [sample_color_image_rand_segment(CROP, 3, rand_seed=s)[0]
              for s in range(3)]

    def segment(img, debug=None):
        return pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, debug_visual=debug, connectivity=False)

    _reset_counters()
    outputs = []
    for i, img in enumerate(images):
        debug = {} if i == 0 else None
        outputs.append(segment(img, debug) + (debug,))
    launches = _counters()
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError('kernels not launched on the main path: %s'
                             % missing)

    for segm, soft, _ in outputs:
        if segm.shape != CROP or soft.shape != CROP + (3,):
            raise AssertionError('bad output shapes %s %s'
                                 % (segm.shape, soft.shape))
        if not np.isfinite(soft).all() or segm.min() < 0 or segm.max() > 2:
            raise AssertionError('non-finite or out-of-range output')
    segm0, _soft0, debug0 = outputs[0]
    ars = adjusted_rand_score(segm0, fixture['segm'])
    slic_eq = float((debug0['slic'] == fixture['slic']).mean())
    print('e2e image 0 vs JAX-CPU: segm ARS %.6f (>= 0.98), SLIC labels '
          'equal %.6f (>= 0.999)' % (ars, slic_eq), flush=True)
    if ars < 0.98 or slic_eq < 0.999:
        raise AssertionError('end-to-end disagrees with the JAX reference')

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img in images:
        segment(img)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(images)
    print('e2e warm ms per 884x1200 image: %.3f' % ms, flush=True)
    print('e2e launches: %s' % json.dumps(launches), flush=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    sys.path.insert(0, ROOT)
    from pyimsegm_tpu_torch import _build
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda, slic_cuda
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment)

    t0 = time.perf_counter()
    for mod in (prep_cuda, slic_cuda, grid_cuda):
        mod._lib()
    print('build: %.2f s total, per library %s'
          % (time.perf_counter() - t0, json.dumps(_build.BUILD_SECONDS)),
          flush=True)

    with np.load(FIXTURE) as npz:
        fixture = {k: npz[k] for k in npz.files}
    img = torch.as_tensor(
        sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
        device=DEVICE)
    records = kernel_phases(torch, img)
    launches = end_to_end(torch, fixture)
    for rec in records:
        rec['launches'] = launches[rec['name']]
    print(json.dumps({'kernels': records}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
