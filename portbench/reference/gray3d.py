"""Plain reference of the unsupervised gray-volume path: 3D SLIC
supervoxels, gray features standardised over the non-empty supervoxels, a
GMM fitted on the volume, the 125-neighbour supervoxel MRF and the lookup,
chained as ``pipe_gray3d_slic_features_model_graphcut`` chains them.

:func:`pipeline` runs it whole, in a precision of
:mod:`portbench.reference.precision` (the control).  :func:`judge` holds
a run's outputs to it stage by stage, each stage recomputed in float32 from
the run's own state before it: the supervoxels from the volume, the
standardised features from the volume and the run's supervoxels, the GMM
from the run's features, and the MRF (and the returned segmentation) from
the run's supervoxels, features and GMM.  The GMM's restarts make its fit
chaotic in its input: one supervoxel moved by a near-tie can change which
restart wins, so the stages are judged apart.
"""

import numpy as np
import torch

from portbench import compare
from portbench.reference.frozen import descriptors
from portbench.reference.frozen.models.class_model import (
    class_model_from_numpy, estim_class_model)
from portbench.reference.frozen.ops import graphcut, slic, slic3d
from portbench.reference.precision import precision, rounder

#: the fitted class model's arrays: the scaler, then the GMM
MODEL_ARRAYS = ('scaler_mean', 'scaler_scale', 'weights', 'means', 'covs')


def _geometry(volume, config):
    cfg = slic3d.slic3d_config(tuple(volume.shape), config['sp_size'],
                               tuple(config['spacing']))
    return cfg, slic.compactness_from_regul(config['sp_size'],
                                            config['sp_regul'])


def features_of(volume, labels, config):
    """(standardised features (K, F), mask (K,), centres (K, 3))."""
    cfg, _ = _geometry(volume, config)
    counts, centers = slic3d.grid3d_geometry(labels, cfg)
    mask = (counts > 0).to(torch.float32)
    features, _ = descriptors.compute_selected_features_gray3d(
        volume, labels.reshape(-1), cfg.n_segments, config['dict_features'],
        grid_ctx3d=(labels, cfg))
    n = torch.clamp_min(torch.sum(mask), 1.0)
    mu = torch.sum(features * mask[:, None], 0) / n
    sd = torch.sqrt(torch.sum(((features - mu) ** 2) * mask[:, None], 0) / n)
    return (features - mu) / torch.clamp_min(sd, 1e-12), mask, centers


def mrf_of(volume, labels, proba, centers, config):
    """(Z, H, W) class ids of the voxels."""
    cfg, _ = _geometry(volume, config)
    graph = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, float(config['gc_regul']), centers,
        grid_ctx3d=(labels, cfg))
    return slic3d.grid3d_lookup(graph, labels, cfg)


def pipeline(volume, config, device, mode='float32'):
    """The whole path on one host volume in precision ``mode``, each
    stage's float inputs rounded as the mode says: the outputs the
    program's capture hands back."""
    r = rounder(mode)
    with precision(mode, device):
        vol = r(torch.as_tensor(np.asarray(volume), device=device).to(
            torch.float32))
        cfg, m = _geometry(vol, config)
        labels = slic3d.slic3d_segment(vol, cfg, m)
        features, mask, centers = features_of(vol, labels, config)
        model = estim_class_model(r(features), config['nb_classes'],
                                  config['estim_model'], sample_weight=mask,
                                  seed=0)
        proba = model.predict_proba(r(features))
        segm = mrf_of(vol, labels, r(proba), centers, config)
    return {'labels': labels.cpu().numpy(),
            'features': features.cpu().numpy(),
            'model': {n: getattr(model, n).cpu().numpy()
                      for n in MODEL_ARRAYS},
            'segm': segm.cpu().numpy().astype(np.int64)}


def judge(volume, prog, config, device):
    """Numbers of a run's outputs on one host volume, stage by stage."""
    with precision('float32', device):
        vol = torch.as_tensor(np.asarray(volume), device=device).to(
            torch.float32)
        cfg, m = _geometry(vol, config)
        labels = slic3d.slic3d_segment(vol, cfg, m).cpu().numpy()
        lab_p = torch.as_tensor(prog['labels'], device=device)
        features, mask, centers = features_of(vol, lab_p, config)
        feat_p = torch.as_tensor(prog['features'], device=device)
        model = estim_class_model(feat_p, config['nb_classes'],
                                  config['estim_model'], sample_weight=mask,
                                  seed=0)
        proba = class_model_from_numpy(prog['model']).to(
            device).predict_proba(feat_p)
        segm = mrf_of(vol, lab_p, proba, centers, config)
    return {
        'label_mismatch': compare.mismatch(prog['labels'], labels),
        'feature_err': compare.feature_err(prog['features'],
                                           features.cpu().numpy()),
        'model_err': max(compare.rel_max(prog['model'][n],
                                         getattr(model, n).cpu().numpy())
                         for n in MODEL_ARRAYS),
        'segm_mismatch': compare.mismatch(
            prog['segm'], segm.cpu().numpy().astype(np.int64)),
    }
