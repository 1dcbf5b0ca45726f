"""Per-stage timing of the segmentation pipeline (port of
``pyimsegm_tpu.utils.profiling``).

A stage is timed as the steady-state time of a progressively longer prefix
of the pipeline: the difference between two prefixes is the cost of the
stage the longer one adds.  A delta can come out slightly negative where a
stage overlaps its neighbours.  On the card a prefix is timed with CUDA
events around its warm calls, on the CPU with the host clock.
"""

import time

import torch


def _first_tensor(out):
    """The first tensor in a (nested) tuple / list / dict result."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def time_jitted(fn, *args, reps=5, warmup=1):
    """Steady-state seconds per call of ``fn(*args)``, after ``warmup``
    calls: CUDA events around ``reps`` calls when the result lies on the
    card, else the host clock around them."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    tensor = _first_tensor(out)
    if tensor is not None and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def profile_prefixes(prefixes, *args, reps=5):
    """Time a list of (name, fn) pipeline prefixes on shared args.

    :returns: list of (name, total_s, delta_s), the delta against the
        previous prefix
    """
    rows, prev = [], 0.0
    for name, fn in prefixes:
        t = time_jitted(fn, *args, reps=reps)
        rows.append((name, t, t - prev))
        prev = t
    return rows


def pipeline_stage_profile(images, model, cfg, feats_spec, compactness,
                           gc_regul=2.0, gc_edge_type='model', reps=5,
                           device='cuda'):
    """Stage profile of the batched unsupervised pipeline
    (:func:`pyimsegm_tpu_torch.parallel.batch.segment_images_batch`'s
    per-image core): SLIC, features, model probabilities, MRF, and the
    whole core with the upsampling.

    :param images: (B, H, W, 3) array or tensor (a numpy input runs on
        ``device``)
    :param model: a fitted ``ClassModel`` on the images' device
    :returns: list of (stage, total_s, delta_s)
    """
    from pyimsegm_tpu_torch import descriptors
    from pyimsegm_tpu_torch.ops import graphcut
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.parallel.batch import _segment_one
    from pyimsegm_tpu_torch.utils.device import as_tensor

    spec = dict(feats_spec)

    def features(im, lb):
        return descriptors.compute_selected_features_color2d(
            im, lb.reshape(-1), cfg.n_segments, spec, grid_ctx=(lb, cfg))[0]

    def slic_only(ims):
        return [slic_ops.slic_segment(im, cfg, compactness) for im in ims]

    def with_features(ims):
        return [features(im, slic_ops.slic_segment(im, cfg, compactness))
                for im in ims]

    def with_proba(ims):
        return [model.predict_proba(features(
            im, slic_ops.slic_segment(im, cfg, compactness))) for im in ims]

    def with_mrf(ims):
        outs = []
        for im in ims:
            lb, _counts, centers = slic_ops.slic_segment_with_geometry(
                im, cfg, compactness)
            fts = features(im, lb)
            outs.append(graphcut.segment_graph_cut_general(
                lb, model.predict_proba(fts), cfg.n_segments, image=im,
                features=fts, gc_regul=gc_regul, edge_type=gc_edge_type,
                grid_ctx=(lb, cfg), centers=centers))
        return outs

    def full(ims):
        return [_segment_one(im, model, cfg=cfg, feats_spec=tuple(feats_spec),
                             gc_regul=gc_regul, gc_edge_type=gc_edge_type,
                             compactness=compactness) for im in ims]

    images = as_tensor(images, device).to(torch.float32)
    return profile_prefixes(
        [('slic', slic_only), ('features', with_features),
         ('model_proba', with_proba), ('mrf', with_mrf),
         ('upsample(full)', full)],
        images, reps=reps)
