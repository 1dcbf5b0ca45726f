"""Plain reference of the supervised colour path (BASELINE config 2):
SLIC, connectivity enforcement, colour and LM texture features, a forest's
proba, the 25-neighbour grid MRF with 'model' edges, and the host gather
of the dense maps, chained as ``segment_color2d_slic_features_model_graphcut``
chains them.

:func:`pipeline` runs it whole, in a precision of
:mod:`portbench.reference.precision` (the control).  :func:`judge` holds
a run's outputs to it stage by stage, each stage recomputed in float32 from
the run's own state before it: the labels from the image, the features
from the image and the run's labels, the proba (and the returned soft map)
from the run's features.  A near-tie that moves one pixel of one
superpixel so stays in the stage where it happens.  The MRF's labels do
not move when its inputs are rounded to bfloat16 (its decisions have wide
margins), so the returned segmentation is held to the whole path from the
image instead.
"""

import numpy as np
import torch

from portbench import compare
from portbench.reference.frozen import descriptors
from portbench.reference.frozen.models import forest as forest_mod
from portbench.reference.frozen.ops import graphcut, grid, slic
from portbench.reference.precision import precision, rounder


def forest_proba(forest, features):
    """(K, C) mean leaf distributions of the forest arrays on the scaled
    features (NaN read as 0)."""
    dev = features.device
    x = torch.nan_to_num(features).to(torch.float32)
    mu = torch.as_tensor(np.asarray(forest['scaler_mean'], np.float32),
                         device=dev)
    sd = torch.as_tensor(np.asarray(forest['scaler_std'], np.float32),
                         device=dev)
    return forest_mod._forest_predict(
        torch.as_tensor(np.asarray(forest['feat'], np.int64), device=dev),
        torch.as_tensor(np.asarray(forest['thr'], np.float32), device=dev),
        torch.as_tensor(np.asarray(forest['leaf_proba'], np.float32),
                        device=dev),
        int(forest['depth']), (x - mu) / sd)


def _geometry(image, config):
    h, w = image.shape[:2]
    cfg = slic.slic_config(h, w, config['sp_size'])
    return cfg, slic.compactness_from_regul(config['sp_size'],
                                            config['sp_regul'])


def labels_of(image, config):
    """Enforced SLIC labels (H, W) i32 of an (H, W, 3) tensor image."""
    cfg, m = _geometry(image, config)
    labels = slic.slic_segment(image, cfg, m)
    return grid.enforce_grid_connectivity(
        labels, cfg, min_size=int(0.5 * cfg.step * cfg.step))


def features_of(image, labels, config):
    """(features (K, F), centres (K, 2)) of the image over the labels."""
    cfg, _ = _geometry(image, config)
    _counts, centers = slic._labels_geometry(labels, cfg)
    features, _ = descriptors.compute_selected_features_img2d(
        image.to(torch.float32), labels.reshape(-1), cfg.n_segments,
        config['dict_features'], grid_ctx=(labels, cfg))
    return features, centers


def mrf_of(image, labels, proba, centers, config):
    """(K,) MRF class ids of the superpixels."""
    if config['gc_edge_type'] != 'model':
        raise ValueError('the reference has \'model\' edges only')
    cfg, _ = _geometry(image, config)
    return graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, float(config['gc_regul']), centers,
        grid_ctx=(labels, cfg))


def pipeline(image, forest, config, device, mode='float32'):
    """The whole path on one host image in precision ``mode``, each stage's
    float inputs rounded as the mode says: the outputs the program's
    capture hands back."""
    r = rounder(mode)
    with precision(mode, device):
        image = r(torch.as_tensor(np.asarray(image), device=device))
        labels = labels_of(image, config)
        features, centers = features_of(image, labels, config)
        proba = forest_proba(forest, r(features))
        graph = mrf_of(image, labels, r(proba), centers, config)
    labels = labels.cpu().numpy().astype(np.int64)
    proba = proba.cpu().numpy()
    classes = np.asarray(forest['classes'])
    return {'labels': labels, 'features': features.cpu().numpy(),
            'proba': proba, 'segm': classes[graph.cpu().numpy()][labels],
            'soft': proba[labels]}


def judge(image, prog, forest, config, device):
    """Numbers of a run's outputs on one host image: the stages, and the
    returned labels and segmentation against the whole path's."""
    whole = pipeline(image, forest, config, device)
    with precision('float32', device):
        image = torch.as_tensor(np.asarray(image), device=device)
        features, _ = features_of(image, torch.as_tensor(
            prog['labels'].astype(np.int32), device=device), config)
        proba = forest_proba(
            forest, torch.as_tensor(prog['features'], device=device))
    return {
        'label_mismatch': compare.mismatch(prog['labels'], whole['labels']),
        'feature_err': compare.feature_err(prog['features'],
                                           features.cpu().numpy()),
        'soft_err': compare.max_abs(prog['soft'],
                                    proba.cpu().numpy()[prog['labels']]),
        'segm_mismatch': compare.mismatch(prog['segm'], whole['segm']),
    }
