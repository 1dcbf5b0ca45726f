"""Object (egg) centre detection: candidate features, classification,
density clustering, evaluation (port of ``pyimsegm_tpu.centers``).

SLIC centres are the candidate points.  Their features are annuli label
histograms (``ops/histogram.py``) and phase-aligned ray distances
(``ops/ray.py``); a classifier scores the candidates and DBSCAN merges the
positive ones into centres.

:func:`load_compute_detect_centers` takes one of two routes.  With a
fitted :class:`~pyimsegm_tpu_torch.classification.Classifier` and the
single-ray-type recipe, the chain runs on the device from the image to the
eps-graph components with no host round trip between its stages (SLIC and
the enforcement on the hand kernels, one ``device_predict_proba`` call);
each stage opens a ``pyimsegm:<stage>`` profiler range.  Any other
classifier or recipe takes the staged route, stage by stage through the
host, as the reference's scripts chain them.
"""

import logging

import numpy as np
import torch

from pyimsegm_tpu_torch.classification import (
    Classifier,
    balance_dataset_by_,
    create_classif_search_train_export,
)
from pyimsegm_tpu_torch.models.clustering import dbscan, pairwise_dist2
from pyimsegm_tpu_torch.ops.histogram import compute_label_histograms_positions
from pyimsegm_tpu_torch.ops.ray import (compute_ray_features_positions,
                                        shift_ray_features)
from pyimsegm_tpu_torch.utils.device import as_tensor, stage_range

#: default parameters of the center-detection chain
CENTER_PARAMS = {
    'slic_size': 25,
    'slic_regul': 0.3,
    'fts_hist_diams': [10, 50, 100, 200, 300],
    'fts_ray_step': 15,
    'fts_ray_types': [('up', [0])],
    'fts_ray_closer': True,
    'fts_ray_smooth': 0,
    'pca_coef': None,
    'balance': 'unique',
    'classif': 'RandForest',
    'nb_classif_search': 50,
    'dict_relabel': None,
    'center_dist_thr': 50,
    # positive-class probability threshold for candidate detection (the
    # reference's argmax is 0.5 for two classes)
    'detect_proba_thr': 0.3,
}

#: DBSCAN defaults
CLUSTER_PARAMS = {
    'DBSCAN_max_dist': 50,
    'DBSCAN_min_samples': 1,
}

#: rounds of label propagation between two host checks of the fixed point
_PROPAGATE_ROUNDS = 8


def compute_points_features(segm, points, params, device='cuda'):
    """Feature matrix of candidate points: annuli label histograms per
    diameter, then ray features per (edge, border labels) type, optionally
    the per-angle minimum over the types before the phase alignment.

    :returns: (features (P, F) numpy, names)
    """
    points = np.asarray(points)
    features = np.empty((len(points), 0))
    feature_names = []

    if params.get('fts_hist_diams') is not None:
        hist, names_hist = compute_label_histograms_positions(
            np.asarray(segm), points.astype(int),
            diameters=tuple(params['fts_hist_diams']), device=device)
        features = np.hstack((features, hist.cpu().numpy()))
        feature_names += names_hist

    if params.get('fts_ray_step') is not None:
        ray_types = params.get('fts_ray_types', [('up', [0])])
        perform_closer = params.get('fts_ray_closer', False) \
            and len(ray_types) > 1
        shifting = not perform_closer
        list_rays, names_ray = [], []
        for ray_edge, ray_border in ray_types:
            rays, _, names_ray = compute_ray_features_positions(
                np.asarray(segm), points,
                angle_step=params['fts_ray_step'], edge=ray_edge,
                border_labels=ray_border,
                smooth_ray=params.get('fts_ray_smooth', 0),
                shifting=shifting, device=device)
            if perform_closer:
                list_rays.append(rays)
            else:
                features = np.hstack((features, rays))
                feature_names += names_ray
        if perform_closer:
            closest = np.min(np.array(list_rays), axis=0)
            rays = np.array([shift_ray_features(r)[0] for r in closest])
            features = np.hstack((features, rays))
            feature_names += names_ray

    return features, feature_names


def estim_points_compute_features(name, img, segm, params, device='cuda'):
    """Candidate points (the centres of the enforced SLIC superpixels) and
    their features.

    :returns: (name, slic, points, features, names)
    """
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    from pyimsegm_tpu_torch.superpixels import superpixel_centers
    if img.shape[:2] != segm.shape[:2]:
        raise ValueError('not matching shapes: %r : %r'
                         % (img.shape, segm.shape))
    slic = segment_slic_img2d(img, sp_size=params['slic_size'],
                              relative_compact=params['slic_regul'],
                              device=device)
    centers = superpixel_centers(slic, device=device)
    features, names = compute_points_features(segm, centers, params,
                                              device=device)
    return name, slic, centers, features, names


def compute_min_dist_2_centers(centers, points, device='cuda'):
    """Min distance and argmin centre per point."""
    d2 = pairwise_dist2(np.asarray(points, float), np.asarray(centers, float),
                        device=device).cpu().numpy()
    return np.sqrt(d2.min(axis=1)), d2.argmin(axis=1)


def label_close_points(centers, points, params, device='cuda'):
    """Candidate labels: 1 within ``center_dist_thr`` of a true centre
    (``centers`` a list), or a lookup into a centre-annotation mask
    (``centers`` an array)."""
    if isinstance(centers, list):
        if not centers:
            return np.zeros(len(points), dtype=int)
        min_dist, _ = compute_min_dist_2_centers(centers, points, device)
        labels = (min_dist <= params['center_dist_thr']).astype(int)
    elif isinstance(centers, np.ndarray):
        mx = np.asarray(points, int)
        labels = centers[mx[:, 0], mx[:, 1]]
    else:
        logging.warning('not relevant centers info of type "%s"',
                        type(centers))
        labels = np.full(len(points), -1)
    return np.asarray(labels)


def train_center_classifier(list_segms, list_imgs, list_centers, params=None,
                            path_out=None, device='cuda'):
    """Per-image candidates, features and labels, balancing, the
    randomised hyper-parameter search and the final fit.

    :returns: (fitted Classifier, dict with per-image point data)
    """
    params = dict(CENTER_PARAMS, **(params or {}))
    dict_imgs = {}
    all_fts, all_lbs = [], []
    for i, (img, segm, centers) in enumerate(
            zip(list_imgs, list_segms, list_centers)):
        name = 'img_%03d' % i
        _, slic, points, fts, _ = estim_points_compute_features(
            name, img, segm, params, device=device)
        labels = label_close_points(list(map(tuple, centers)), points, params,
                                    device=device)
        dict_imgs[name] = {'slic': slic, 'points': points, 'features': fts,
                           'labels': labels}
        all_fts.append(fts)
        all_lbs.append(labels)
    features = np.concatenate(all_fts)
    labels = np.concatenate(all_lbs)
    if params.get('balance'):
        features, labels = balance_dataset_by_(
            features, labels, balance_type=params['balance'], device=device)
    classif, _ = create_classif_search_train_export(
        params['classif'], features, labels,
        nb_search_iter=min(params.get('nb_classif_search', 1), 10),
        pca_coef=params.get('pca_coef'), path_out=path_out, device=device)
    return classif, dict_imgs


def detect_center_candidates(name, img, segm, centers_gt, slic, points,
                             features, params, classif: Classifier):
    """Classify candidate points and keep the positives; a
    ``detect_proba_thr`` other than 0.5 thresholds the positive class's
    probability instead of taking the argmax.

    :returns: (candidate points (P, 2), labels (P,))
    """
    thr = (params or {}).get('detect_proba_thr', 0.5)
    classes = list(np.asarray(classif.classes_))
    if thr != 0.5 and 1 in classes:
        proba = np.asarray(classif.predict_proba(features))
        labels = (proba[:, classes.index(1)] >= thr).astype(int)
    else:
        labels = classif.predict(features)
    candidates = np.asarray(points)[np.asarray(labels) == 1]
    return candidates, labels


def cluster_center_candidates(points, max_dist=100, min_samples=1,
                              device='cuda'):
    """DBSCAN merge of positive candidates into centres.

    :returns: (centres (C, 2), cluster labels per point; -1 = noise)
    """
    points = np.asarray(points, float)
    if len(points) == 0:
        return points, []
    labels = dbscan(points, eps=max_dist, min_samples=min_samples,
                    device=device)
    centers = [np.mean(points[labels == i], axis=0)
               for i in range(labels.max() + 1) if np.any(labels == i)]
    return np.array(centers), labels


def eps_components(centers, cand, eps):
    """Connected components of the eps-graph over the candidates (DBSCAN
    with ``min_samples=1``): each candidate's label is the smallest index
    it reaches through edges of length <= eps, every other point gets P.
    Min-label propagation runs ``_PROPAGATE_ROUNDS`` rounds between two
    host checks of the fixed point.

    :param centers: (P, 2) f32 tensor; ``cand`` (P,) bool
    :returns: (P,) int64 labels
    """
    p = centers.shape[0]
    d2 = pairwise_dist2(centers)
    adj = (d2 <= eps * eps) & cand[:, None] & cand[None, :]
    lab = torch.where(cand, torch.arange(p, device=centers.device), p)
    none = torch.full_like(lab, p)
    while True:
        start = lab
        for _ in range(_PROPAGATE_ROUNDS):
            lab = torch.minimum(lab, torch.where(adj, lab[None, :],
                                                 none[None, :]).amin(dim=1))
        if torch.equal(lab, start):
            return lab


def _fused_features(segm, centers, nb_labels, params):
    """The fused route's features at (P, 2) f32 ``centers``: annuli
    histograms at the truncated centres, and the rays of the first type
    ('up') before and after their alignment.

    :returns: (hists (P, n_diam * L), rays (P, A), aligned rays (P, A),
        shifts (P,)) tensors
    """
    from pyimsegm_tpu_torch.ops.histogram import label_hist_maps, rings_at
    from pyimsegm_tpu_torch.ops.ray import (ray_features_positions_core,
                                            shift_ray_features_batched)
    with stage_range('hist'):
        cmaps, smaps = label_hist_maps(segm, nb_labels,
                                       tuple(params['fts_hist_diams']))
        hists = rings_at(cmaps, smaps, centers.to(torch.int64))
    with stage_range('rays'):
        seg_binary = torch.zeros(segm.shape[:2], dtype=torch.bool,
                                 device=segm.device)
        for lb in params.get('fts_ray_types', [('up', [0])])[0][1]:
            seg_binary |= segm == lb
        rays = ray_features_positions_core(
            seg_binary, centers, angle_step=float(params['fts_ray_step']),
            edge='up')
    with stage_range('shift'):
        aligned, shifts = shift_ray_features_batched(rays)
    return hists, rays, aligned, shifts


def _detect_fused(img, segm, nb_labels, classif, params):
    """The device chain of :func:`load_compute_detect_centers`: SLIC,
    enforcement, grid geometry, annuli histograms and aligned rays at the
    centres, the classifier, the threshold and the eps-graph components.

    :returns: (labels, centres, valid, candidate mask, components) tensors
    """
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops.grid import enforce_grid_connectivity
    from pyimsegm_tpu_torch.pipelines import _grid_geometry

    cfg = slic_ops.slic_config(img.shape[0], img.shape[1],
                               params['slic_size'])
    m = slic_ops.compactness_from_regul(params['slic_size'],
                                        params['slic_regul'])
    classes = list(np.asarray(classif.classes_))
    with stage_range('slic'):
        labels = slic_ops.slic_segment(img, cfg, m)
    with stage_range('enforce'):
        labels = enforce_grid_connectivity(
            labels, cfg, min_size=int(0.5 * cfg.step * cfg.step))
    with stage_range('geometry'):
        counts, centers = _grid_geometry(labels, cfg)
        valid = counts > 0
    hists, _, rays, _ = _fused_features(segm, centers, nb_labels, params)
    with stage_range('classify'):
        features = torch.nan_to_num(torch.cat([hists, rays], dim=1))
        proba = classif.device_predict_proba(features)
        cand = (proba[:, classes.index(1)]
                >= float(params.get('detect_proba_thr', 0.5))) & valid
    with stage_range('cluster'):
        comp = eps_components(centers, cand, float(params['DBSCAN_max_dist']))
    return labels, centers, valid, cand, comp


def _fused_ok(classif, params):
    """The conditions under which the device chain computes what the
    staged route does."""
    ray_types = params.get('fts_ray_types', [('up', [0])])
    return (hasattr(classif, 'device_predict_proba')
            and getattr(classif, '_params', None) is not None
            and len(ray_types) == 1 and ray_types[0][0] == 'up'
            and not params.get('fts_ray_smooth', 0)
            and params.get('fts_hist_diams') is not None
            and params.get('fts_ray_step') is not None
            and 1 in list(np.asarray(classif.classes_)))


def load_compute_detect_centers(img, segm, classif, params=None,
                                device='cuda'):
    """One-image prediction chain: candidates -> classify -> cluster.

    :param img: (H, W, 3) image; a tensor runs on its device, anything
        else on ``device``
    :param segm: (H, W) tissue segmentation (integer labels)
    :returns: dict with slic, points, candidates, clustered centres and
        their cluster labels (numpy)
    """
    merged = dict(CENTER_PARAMS)
    merged.update(CLUSTER_PARAMS)
    merged.update(params or {})
    params = merged

    if _fused_ok(classif, params):
        img_t = as_tensor(img, device)
        segm_t = as_tensor(segm, img_t.device).to(torch.int32)
        out = _detect_fused(img_t, segm_t, int(segm_t.max()) + 1, classif,
                            params)
        labels, centers_np, valid_np, cand_np, comp_np = [
            t.cpu().numpy() for t in out]
        candidates = centers_np[cand_np]
        comps = comp_np[cand_np]
        uniq = np.unique(comps)
        centres_out = np.array([candidates[comps == u].mean(axis=0)
                                for u in uniq]) if len(uniq) else \
            np.zeros((0, 2))
        remap = {u: i for i, u in enumerate(uniq)}
        clust_labels = np.array([remap[u] for u in comps], dtype=int)
        return {'slic': labels, 'points': centers_np[valid_np],
                'candidates': candidates, 'centers': centres_out,
                'clust_labels': clust_labels}

    img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
    segm = segm.cpu().numpy() if isinstance(segm, torch.Tensor) else segm
    _, slic, points, features, _ = estim_points_compute_features(
        '', img, segm, params, device=device)
    candidates, _ = detect_center_candidates(
        '', img, segm, None, slic, points, features, params, classif)
    centers, clust_labels = cluster_center_candidates(
        candidates, max_dist=params['DBSCAN_max_dist'],
        min_samples=params['DBSCAN_min_samples'], device=device)
    return {'slic': slic, 'points': points, 'candidates': candidates,
            'centers': centers, 'clust_labels': clust_labels}


def evaluate_detected_centers(centers_detected, centers_true, dist_thr=50,
                              device='cuda'):
    """Detection statistics within a distance tolerance.

    :returns: dict with TP / FP / FN, precision, recall, f1
    """
    centers_detected = np.asarray(centers_detected, float)
    centers_true = np.asarray(centers_true, float)
    if len(centers_detected) == 0:
        fn = len(centers_true)
        return {'TP': 0, 'FP': 0, 'FN': fn, 'precision': 0.0, 'recall': 0.0,
                'f1': 0.0}
    if len(centers_true) == 0:
        return {'TP': 0, 'FP': len(centers_detected), 'FN': 0,
                'precision': 0.0, 'recall': 0.0, 'f1': 0.0}
    d2 = pairwise_dist2(centers_detected, centers_true,
                        device=device).cpu().numpy()
    matched_true = np.sqrt(d2.min(axis=0)) <= dist_thr
    matched_det = np.sqrt(d2.min(axis=1)) <= dist_thr
    tp = int(matched_true.sum())
    fn = int((~matched_true).sum())
    fp = int((~matched_det).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {'TP': tp, 'FP': fp, 'FN': fn, 'precision': precision,
            'recall': recall, 'f1': f1}
