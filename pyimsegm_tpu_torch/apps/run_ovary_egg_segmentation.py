"""Instance segmentation of eggs: the per-method zoo.

Port of the JAX package's ``apps/run_ovary_egg_segmentation.py``, after the
reference's ``run_ovary_egg-segmentation.py``:
runs the selected segmentation methods per image (centres given by
annotation/detection), exporting one instance map per method:

* ``ellipse_moments`` / ``ellipse_ransac_mmt`` / ``ellipse_ransac_crit{,2,3}``
  — ellipse fitting on boundary points (moments, inlier RANSAC, and the
  segmentation-criterion RANSAC with three boundary extractors)
* ``GC_pixels-{small,large,shape}`` / ``GC_slic-{small,large,shape}`` —
  one-shot object GraphCut on pixels / superpixels
* ``RG2SP_greedy-{single,mixture}`` / ``RG2SP_GC-{single,mixture}`` — region
  growing with the learned shape priors
* ``watershed[_morph]`` — marker-controlled watershed from the centres

Example::

    python -m pyimsegm_tpu_torch.apps.run_ovary_egg_segmentation \
        --path_list '.../list_imgs-segm-center-points_short.csv' \
        --path_out ./results --methods ellipse_ransac_crit GC_slic-large
"""

import argparse
import logging
import os
import pickle
import time

import numpy as np

from pyimsegm_tpu_torch import ellipse_fitting as ell_fit
from pyimsegm_tpu_torch import region_growing as rg
from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.apps.run_center_candidate_training import (
    load_center_annotation,
    load_triples,
)
from pyimsegm_tpu_torch.utils import data_io

NAME_EXPERIMENT = 'ovary_egg-segmentation'
LIST_SAMPLE_METHODS = (
    'ellipse_moments', 'ellipse_ransac_mmt', 'ellipse_ransac_crit',
    'GC_pixels-large', 'GC_pixels-shape', 'GC_slic-large', 'GC_slic-shape',
    'RG2SP_greedy-mixture', 'RG2SP_GC-mixture', 'watershed_morph',
)
#: default parameters (`run_ovary_egg-segmentation.py:114-134`); the fg-prob
#: tables map the ovary classes (bg, funicular, nurse, cytoplasm)
SEGM_PARAMS = {
    'tab-proba_ellipse': [0.01, 0.95, 0.95, 0.85],
    'tab-proba_graphcut': [0.01, 0.6, 0.99, 0.75],
    'tab-proba_RG2SP': [0.01, 0.6, 0.95, 0.75],
    'gc-pixel_regul': 3.,
    'gc-slic_regul': 2.,
    'RG2SP-shape': 5.,
    'RG2SP-pairwise': 3.,
    'RG2SP-swap': True,
    'label_trans': [0.1, 0.03],
    'overlap_threshold': 0.45,
    'slic_size': 40,
    'slic_regul': 0.3,
    'device': 'cuda',
}


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_list', '', 'CSV list of triples',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    common.add_path_arg(parser, 'path_shape_models', '',
                        'folder with RG2SP shape model pkls')
    parser.add_argument('--methods', type=str, nargs='*', default=None)
    parser.add_argument('--name', type=str, default='ovary')
    common.add_device_arg(parser, params.get('device', 'cuda'))
    return common.parse_arg_params(parser, params)


# ------------------------------------------------------------- the methods ---
# Each method takes the JAX app's arguments and a trailing ``device``, where
# its device work runs.

def segment_fit_ellipse(seg, centres, fn_preproc_points, thr_overlap=0.45,
                        device='cuda'):
    """Direct LSQ ellipse per centre (`run_ovary_egg-segmentation.py:383`)."""
    points_centers = fn_preproc_points(seg, centres, device=device)
    segm_obj = np.zeros(np.asarray(seg).shape, dtype=int)
    for i, points in enumerate(points_centers):
        model = ell_fit.EllipseModelSegm(device=device)
        if len(points) < 5 or not model.estimate(np.asarray(points)):
            continue
        segm_obj = ell_fit.add_overlap_ellipse(segm_obj, model.params, i + 1,
                                               thr_overlap)
    return segm_obj


def segment_fit_ellipse_ransac(seg, centres, fn_preproc_points, nb_inliers=0.6,
                               thr_overlap=0.45, device='cuda'):
    """Classic inlier RANSAC per centre (`:409`); trials from numpy's global
    random state."""
    points_centers = fn_preproc_points(seg, centres, device=device)
    segm_obj = np.zeros(np.asarray(seg).shape, dtype=int)
    for i, points in enumerate(points_centers):
        points = np.asarray(points)
        if len(points) < 6:
            continue
        nb = max(int(len(points) * nb_inliers), 5)
        best_model, best_in = None, -1
        for _ in range(30):
            idx = np.random.choice(len(points), nb, replace=False)
            model = ell_fit.EllipseModelSegm(device=device)
            if not model.estimate(points[idx]):
                continue
            inl = int(np.sum(np.abs(model.residuals(points)) < 3))
            if inl > best_in:
                best_model, best_in = model, inl
        if best_model is None:
            continue
        segm_obj = ell_fit.add_overlap_ellipse(segm_obj, best_model.params,
                                               i + 1, thr_overlap)
    return segm_obj


def segment_fit_ellipse_ransac_segm(seg, centres, fn_preproc_points,
                                    table_prob, nb_inliers=0.35,
                                    thr_overlap=0.45, device='cuda'):
    """Segmentation-criterion RANSAC (`:444`)."""
    slic, points_all, labels = ell_fit.get_slic_points_labels(
        np.asarray(seg), slic_size=15, slic_regul=0.1, device=device)
    weights = np.bincount(slic.ravel())
    points_centers = fn_preproc_points(seg, centres, device=device)
    segm_obj = np.zeros(np.asarray(seg).shape, dtype=int)
    for i, points in enumerate(points_centers):
        points = np.asarray(points)
        if len(points) < 6:
            continue
        model, _ = ell_fit.ransac_segm(points, ell_fit.EllipseModelSegm,
                                       points_all, weights, labels,
                                       table_prob, nb_inliers, 3,
                                       max_trials=30, device=device)
        if model is None:
            continue
        segm_obj = ell_fit.add_overlap_ellipse(segm_obj, model.params, i + 1,
                                               thr_overlap)
    return segm_obj


def segment_graphcut_pixels(seg, centres, labels_fg_prob, gc_regul=1.,
                            seed_size=10, coef_shape=0.,
                            shape_mean_std=(50., 10.), device='cuda'):
    return rg.object_segmentation_graphcut_pixels(
        np.asarray(seg), centres, labels_fg_prob, gc_regul, seed_size,
        coef_shape, shape_mean_std, device=device)


def segment_graphcut_slic(slic, seg, centres, labels_fg_prob, gc_regul=1.,
                          multi_seed=False, coef_shape=0., device='cuda'):
    gc_labels = rg.object_segmentation_graphcut_slic(
        np.asarray(slic), np.asarray(seg), centres, labels_fg_prob, gc_regul,
        edge_coef=1., edge_type='model', coef_shape=coef_shape,
        add_neighbours=multi_seed, device=device)
    return np.asarray(gc_labels)[np.asarray(slic)]


def load_shape_model(path_model, device='cuda'):
    """(shape type, (model, tables)) of a shape model pickled by
    ``run_RG2Sp_estim_shape_models``, its mixture on ``device``."""
    with open(path_model, 'rb') as fp:
        state = pickle.load(fp)
    return state['name'], rg.shape_model_from_numpy(state['model'],
                                                    device=device)


def segment_rg2sp_greedy(slic, seg, centres, labels_fg_prob, path_model,
                         coef_shape, coef_pairwise, allow_obj_swap,
                         prob_label_trans, dict_thresholds, device='cuda'):
    shape_type, shape_model = load_shape_model(path_model, device)
    prob_fg = rg.compute_segm_prob_fg(np.asarray(slic), np.asarray(seg),
                                      labels_fg_prob)
    labels = rg.region_growing_shape_slic_greedy(
        np.asarray(slic), prob_fg, centres, shape_model,
        shape_type=shape_type, coef_shape=coef_shape,
        coef_pairwise=coef_pairwise, prob_label_trans=tuple(prob_label_trans),
        allow_obj_swap=allow_obj_swap, dict_thresholds=dict_thresholds,
        nb_iter=100, device=device)
    return labels[np.asarray(slic)]


def segment_rg2sp_graphcut(slic, seg, centres, labels_fg_prob, path_model,
                           coef_shape, coef_pairwise, allow_obj_swap,
                           prob_label_trans, dict_thresholds, device='cuda'):
    shape_type, shape_model = load_shape_model(path_model, device)
    prob_fg = rg.compute_segm_prob_fg(np.asarray(slic), np.asarray(seg),
                                      labels_fg_prob)
    labels = rg.region_growing_shape_slic_graphcut(
        np.asarray(slic), prob_fg, centres, shape_model,
        shape_type=shape_type, coef_shape=coef_shape,
        coef_pairwise=coef_pairwise, prob_label_trans=tuple(prob_label_trans),
        allow_obj_swap=allow_obj_swap, dict_thresholds=dict_thresholds,
        nb_iter=50, device=device)
    return labels[np.asarray(slic)]


def segment_watershed(seg, centres, post_morph=False, device='cuda'):
    """Marker-controlled watershed from the centres on the host
    (`run_ovary_egg-segmentation.py:630`); the optional opening of each
    object on ``device``."""
    from scipy import ndimage
    seg = np.asarray(seg)
    fg = seg > 0
    dist = ndimage.distance_transform_edt(fg)
    markers = np.zeros(seg.shape, dtype=np.int32)
    for i, c in enumerate(centres):
        markers[int(c[0]), int(c[1])] = i + 1
    inv = np.asarray((dist.max() - dist) / max(dist.max(), 1e-9) * 250,
                     np.uint16)
    segm_obj = ndimage.watershed_ift(inv.astype(np.uint16), markers)
    segm_obj[~fg] = 0
    segm_obj[segm_obj < 0] = 0
    if post_morph:
        from pyimsegm_tpu_torch.ops.morphology import binary_opening
        out = np.zeros_like(segm_obj)
        for lb in range(1, segm_obj.max() + 1):
            m = binary_opening(segm_obj == lb, 3, device=device)
            out[m.cpu().numpy()] = lb
        segm_obj = out
    return segm_obj


def simplify_segm_3cls(seg, lut=(0., 0.8, 1.), smooth=True):
    """Collapse a multi-class segmentation into 3 intensity levels with
    hole-filling (`run_ovary_egg-segmentation.py:642-658`)."""
    from scipy import ndimage
    seg = np.asarray(seg)
    segm = seg.copy()
    segm[seg > 1] = 2
    if np.sum(seg > 0) > 0:
        filled = ndimage.binary_fill_holes(seg > 0)
        segm[np.logical_and(seg == 0, filled)] = 2
    segm = np.array(lut)[segm]
    if smooth:
        segm = ndimage.gaussian_filter(segm, 5)
    return segm


def morphsnakes_inputs(img, centres, init_center=True, bb_dist=15,
                       max_iter=300):
    """(image (H, W) float, initial level sets (N, H, W), iteration count)
    of :func:`segment_morphsnakes`: channel 0 of a colour image, radius-15
    circles at the centres (or one box ``bb_dist`` inside the border), and
    half the image diagonal in steps, at most ``max_iter``."""
    from pyimsegm_tpu_torch.ops import snakes
    img = np.asarray(img, float)
    if img.ndim == 3:
        img = img[:, :, 0]
    if init_center:
        masks = snakes.circle_masks(img.shape, centres, radius=15)
    else:
        box = np.zeros(img.shape, np.float32)
        box[bb_dist:-bb_dist, bb_dist:-bb_dist] = 1
        masks = box[None]
    n_iter = min(int(np.hypot(*img.shape) / 2.0), max_iter)
    return img, masks, n_iter


def segment_morphsnakes(img, centres, init_center=True, smoothing=5,
                        lambdas=(3, 3), bb_dist=15, max_iter=300,
                        device='cuda'):
    """Multi-object morphological ACWE on the device
    (`run_ovary_egg-segmentation.py:335-361`): circle init at the centres,
    joint level-set evolution for ~diag/2 steps."""
    from pyimsegm_tpu_torch.ops import snakes
    image, masks, n_iter = morphsnakes_inputs(img, centres, init_center,
                                              bb_dist, max_iter)
    labels = snakes.morph_acwe_multi(image, masks, n_iter=n_iter,
                                     smoothing=smoothing, lambda1=lambdas[0],
                                     lambda2=lambdas[1], device=device)
    return labels.cpu().numpy()


def create_dict_segmentation(params, slic, segm, img, centers):
    """Method name -> (function, args) registry
    (`run_ovary_egg-segmentation.py:661-724`)."""
    p_single = os.path.join(params.get('path_shape_models', ''),
                            'RG2SP_eggs_single-model.pkl')
    p_mix = os.path.join(params.get('path_shape_models', ''),
                         'RG2SP_eggs_mixture-model.pkl')
    params_rg = lambda path: (slic, segm, centers, params['tab-proba_RG2SP'],
                              path, params['RG2SP-shape'],
                              params['RG2SP-pairwise'], params['RG2SP-swap'],
                              params['label_trans'],
                              rg.RG2SP_THRESHOLDS)
    tab_gc = params['tab-proba_graphcut']
    dict_segment = {
        'ellipse_moments': (segment_fit_ellipse,
                            (segm, centers,
                             ell_fit.prepare_boundary_points_ray_dist)),
        'ellipse_ransac_mmt': (segment_fit_ellipse_ransac,
                               (segm, centers,
                                ell_fit.prepare_boundary_points_ray_dist)),
        'ellipse_ransac_crit': (segment_fit_ellipse_ransac_segm,
                                (segm, centers,
                                 ell_fit.prepare_boundary_points_ray_edge,
                                 params['tab-proba_ellipse'])),
        'ellipse_ransac_crit2': (segment_fit_ellipse_ransac_segm,
                                 (segm, centers,
                                  ell_fit.prepare_boundary_points_ray_join,
                                  params['tab-proba_ellipse'])),
        'ellipse_ransac_crit3': (segment_fit_ellipse_ransac_segm,
                                 (segm, centers,
                                  ell_fit.prepare_boundary_points_ray_mean,
                                  params['tab-proba_ellipse'])),
        'GC_pixels-small': (segment_graphcut_pixels,
                            (segm, centers, tab_gc,
                             params['gc-pixel_regul'], 10)),
        'GC_pixels-large': (segment_graphcut_pixels,
                            (segm, centers, tab_gc,
                             params['gc-pixel_regul'], 30)),
        'GC_pixels-shape': (segment_graphcut_pixels,
                            (segm, centers, tab_gc,
                             params['gc-pixel_regul'], 10, 0.1)),
        'GC_slic-small': (segment_graphcut_slic,
                          (slic, segm, centers, tab_gc,
                           params['gc-slic_regul'], False)),
        'GC_slic-large': (segment_graphcut_slic,
                          (slic, segm, centers, tab_gc,
                           params['gc-slic_regul'], True)),
        'GC_slic-shape': (segment_graphcut_slic,
                          (slic, segm, centers, tab_gc, 1., False, 0.1)),
        'RG2SP_greedy-single': (segment_rg2sp_greedy, params_rg(p_single)),
        'RG2SP_greedy-mixture': (segment_rg2sp_greedy, params_rg(p_mix)),
        'RG2SP_GC-single': (segment_rg2sp_graphcut, params_rg(p_single)),
        'RG2SP_GC-mixture': (segment_rg2sp_graphcut, params_rg(p_mix)),
        'watershed': (segment_watershed, (segm, centers)),
        'watershed_morph': (segment_watershed, (segm, centers, True)),
        'morph-snakes_seg': (segment_morphsnakes,
                             (simplify_segm_3cls(segm) if segm is not None
                              else None, centers, True, 3, (2, 1))),
        'morph-snakes_img': (segment_morphsnakes, (img, centers)),
    }
    if params.get('methods'):
        sel = [n.lower() for n in params['methods']]
        dict_segment = {n: v for n, v in dict_segment.items()
                        if n.lower() in sel}
    return dict_segment


def image_segmentation(name, img, segm, centers, params, path_out):
    """The zoo's SLIC, then every selected method, one instance map each
    (a method that fails is logged and skipped); returns the name."""
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    device = params.get('device', 'cuda')
    slic = np.asarray(segment_slic_img2d(
        img, sp_size=params['slic_size'],
        relative_compact=params['slic_regul'], device=device))
    methods = create_dict_segmentation(params, slic, segm, img, centers)
    for method, (fn, args) in methods.items():
        t0 = time.time()
        try:
            segm_obj = fn(*args, device=device)
        except Exception:
            logging.exception('method "%s" failed on "%s"', method, name)
            continue
        folder = os.path.join(path_out, method)
        common.export_segm(folder, name, np.asarray(segm_obj).astype(np.uint8))
        logging.info('%s/%s done in %.1fs (objects: %i)', method, name,
                     time.time() - t0, int(np.max(segm_obj)))
    return name


def main(params):
    path_out = common.setup_experiment(params, NAME_EXPERIMENT)
    triples = load_triples(params['path_list'])
    for p_img, p_segm, p_ctr in triples:
        img, name = common.load_image_by_type(p_img, '2d_rgb')
        segm = np.asarray(data_io.load_image_2d(p_segm)[0]).astype(int)
        centers = load_center_annotation(p_ctr)
        logging.info('image "%s" with %i centres', name, len(centers))
        image_segmentation(name, img, segm, centers, params, path_out)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(SEGM_PARAMS)))
