"""Public segmentation pipelines (port of ``pyimsegm_tpu.pipelines``).

* :func:`pipe_color2d_slic_features_model_graphcut` — unsupervised single
  image: SLIC, features, a class model fitted on the image, MRF;
* :func:`estim_model_classes_group` — fit one class model over a group of
  images;
* :func:`segment_color2d_slic_features_model_graphcut` — segment with a
  fitted class model or a trained classifier;
* :func:`train_classif_color2d_slic_features` — train a classifier on the
  superpixels of annotated images (BASELINE config 2);
* :func:`compute_color2d_superpixels_features` — SLIC + features;
* :func:`wrapper_compute_color2d_slic_features_labels` — SLIC, features
  and the superpixels' annotation labels of one image;
* :func:`pipe_gray3d_slic_features_model_graphcut` — unsupervised gray
  volume: 3D SLIC, gray features (LM texture too), a class model fitted on
  the volume, MRF on the supervoxel grid.

A tensor image runs on its own device; a numpy image on the ``device``
keyword (``'cuda'`` by default; with no card the call raises, and
``device='cpu'`` runs the plain PyTorch path).  Features are any colour
spec (``'color'`` or ``'color_<space>'`` keys, any of mean / std / energy /
median / meanGrad) and the texture keys ``tLM[_short]``, ``tGabor`` and
``tLBP``; the classifiers are every name of
:mod:`pyimsegm_tpu_torch.classification`, and any other model with a numpy
``predict_proba`` and ``classes_`` segments through a host round trip;
SLICO and ``connectivity`` on or off are ported.  ``sp_compat`` raises
``NotImplementedError`` naming the item of ROADMAP.md that brings it.
"""

import numpy as np
import torch

from pyimsegm_tpu_torch import descriptors
from pyimsegm_tpu_torch.classification import Classifier
from pyimsegm_tpu_torch.models.class_model import (ClassModel,
                                                   estim_class_model)
from pyimsegm_tpu_torch.ops import color as color_ops
from pyimsegm_tpu_torch.ops import graphcut
from pyimsegm_tpu_torch.ops import grid as grid_ops
from pyimsegm_tpu_torch.ops import segment_stats
from pyimsegm_tpu_torch.ops import slic as slic_ops
from pyimsegm_tpu_torch.ops import slic3d
from pyimsegm_tpu_torch.ops.grid import grid_lookup
from pyimsegm_tpu_torch.utils.device import as_tensor, stage_range

_MOMENT_FLAGS = ('mean', 'std', 'energy')
#: images held out per CV fold of the classifier search
CROSS_VAL_LEAVE_OUT = 2


def _features_spec(dict_features):
    """Hashable form of the feature dict."""
    return tuple((k, tuple(v)) for k, v in dict_features.items())


def _fusable_color_spec(feats_spec):
    """A single colour key whose stats are all plain moments rides the fused
    final SLIC pass; returns the key or None."""
    if len(feats_spec) != 1:
        return None
    key, flags = feats_spec[0]
    if not key.startswith('color') or not flags:
        return None
    if any(f not in _MOMENT_FLAGS for f in flags):
        return None
    return key


def _moment_features(msums, counts, flags):
    """[mean, std, energy] blocks (in that order, as ``flags`` selects)
    from (K, 6) colour moment sums [sum v, sum v^2] and (K,) counts."""
    blocks = segment_stats.moment_blocks(msums, counts)
    return torch.cat([blocks[f] for f in _MOMENT_FLAGS if f in flags], dim=-1)


def _grid_geometry(labels, cfg):
    """(counts (K,), centres (K, 2)) of grid-structured labels, by one grid
    reduce."""
    return slic_ops._labels_geometry(labels, cfg)


def _slic_features_core(image, cfg, feats_spec, compactness, slico=False,
                        n_iter=slic_ops.DEFAULT_SLIC_ITERS,
                        connectivity=True):
    """SLIC + per-superpixel features.

    A single colour key of plain moments rides the final SLIC pass (the
    fused branch; its moments are of the image converted to the key's
    colour space).  Every other spec, SLICO and a gray image take the
    labels-only SLIC and the descriptors over the grid reduce.  With
    ``connectivity`` the labels are enforced (every superpixel one
    4-connected region, superpixels below half a tile merged into a
    neighbour) before anything is measured over them.

    :param image: (H, W, 3) or (H, W) tensor
    :returns: (labels (H, W) i32, features (K, F), counts (K,),
        centres (K, 2))
    """
    fuse_key = None if (slico or image.ndim != 3) \
        else _fusable_color_spec(feats_spec)
    min_size = int(0.5 * cfg.step * cfg.step)
    if fuse_key is not None:
        img_f = image.to(torch.float32)
        feat_img = (color_ops.convert_img_color_from_rgb(
            img_f, fuse_key.split('_')[-1]) if '_' in fuse_key else img_f)
        flags = dict(feats_spec)[fuse_key]
        labels, counts, centers, msums = slic_ops.slic_segment_with_features(
            image, feat_img, cfg, compactness, n_iter=n_iter)
        if connectivity:
            labels, sums = grid_ops.enforce_minsize_with_moments(
                labels, cfg, min_size, centers, feat_img)
            counts = sums[:, 6]
            centers = sums[:, 7:9] / torch.clamp_min(counts[:, None], 1.0)
            msums = sums[:, :6]
        return labels, _moment_features(msums, counts, flags), counts, centers
    if connectivity or slico:
        with stage_range('slic'):
            labels = slic_ops.slic_segment(image, cfg, compactness,
                                           n_iter=n_iter, slico=slico)
        if connectivity:
            with stage_range('enforce'):
                labels = grid_ops.enforce_grid_connectivity(
                    labels, cfg, min_size=min_size)
        with stage_range('geometry'):
            counts, centers = _grid_geometry(labels, cfg)
    else:
        with stage_range('slic'):
            labels, counts, centers = slic_ops.slic_segment_with_geometry(
                image, cfg, compactness, n_iter=n_iter)
    with stage_range('features'):
        features, _ = descriptors.compute_selected_features_img2d(
            image.to(torch.float32), labels.reshape(-1), cfg.n_segments,
            dict(feats_spec), grid_ctx=(labels, cfg))
    return labels, features, counts, centers


def _segment_with_model_core(image, model: ClassModel, *, cfg, feats_spec,
                             gc_regul, gc_edge_type, compactness,
                             connectivity=True):
    labels, features, _counts, centers = _slic_features_core(
        image, cfg, feats_spec, compactness, connectivity=connectivity)
    proba = model.predict_proba(features)
    segm_soft = grid_lookup(proba, labels, cfg)
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=image.to(torch.float32),
        features=features, gc_regul=gc_regul, edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers)
    segm = grid_lookup(graph_labels, labels, cfg)
    return segm, segm_soft, labels, proba, graph_labels


def _segment_with_classif_core(image, classif, *, cfg, feats_spec, gc_regul,
                               gc_edge_type, compactness, connectivity=True):
    """SLIC -> features (texture banks included) -> classifier predict ->
    MRF, all on the image's device; the ``pyimsegm:<stage>`` ranges
    (``utils.device.stage_range``) split it for a profiler.

    :returns: (labels (H, W) i32, features (K, F), proba (K, C),
        graph_labels (K,))
    """
    labels, features, _counts, centers = _slic_features_core(
        image, cfg, feats_spec, compactness, connectivity=connectivity)
    with stage_range('predict_proba'):
        proba = classif.device_predict_proba(torch.nan_to_num(features))
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=image.to(torch.float32),
        features=features, gc_regul=gc_regul, edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers)
    return labels, features, proba, graph_labels


def _pipe_unsup_core(image, *, cfg, feats_spec, nb_classes, estim_model,
                     pca_coef, use_scaler, gc_regul, gc_edge_type,
                     compactness, seed=0):
    """SLIC -> features -> class model fitted on this image -> proba ->
    MRF -> upsampling, all on the image's device."""
    labels, features, counts, centers = _slic_features_core(
        image, cfg, feats_spec, compactness)
    mask = (counts > 0).to(torch.float32)
    model = estim_class_model(features, nb_classes, estim_model, pca_coef,
                              use_scaler, sample_weight=mask, seed=seed)
    proba = model.predict_proba(features)
    segm_soft = grid_lookup(proba, labels, cfg)
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=image.to(torch.float32),
        features=features, gc_regul=gc_regul, edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers)
    segm = grid_lookup(graph_labels, labels, cfg)
    return segm, segm_soft, labels, features, proba, model, graph_labels


def _model_device(model):
    if isinstance(model, Classifier):
        return model.device
    return next(iter(model.buffers())).device


def _fetch_reconstruct(labels, proba, graph_labels, cfg):
    """(segm, segm_soft) numpy arrays gathered on the host from the (H, W)
    labels (int16 when K allows) and the (K,) / (K, C) tables.

    Equal to fetching the device ``grid_lookup`` outputs only for enforced
    (``connectivity=True``) labels, which all lie in their pixel's 3x3 seed
    window; raw labels must take the device lookup instead."""
    small = labels.to(torch.int16) if cfg.n_segments <= 0x7fff else labels
    labels_np = small.cpu().numpy().astype(np.int64)
    return (graph_labels.cpu().numpy()[labels_np],
            proba.cpu().numpy()[labels_np])


def _to_model_device(image, model):
    """The image as a tensor on the model's device (a numpy image is moved
    there; a tensor image must already be there)."""
    device = _model_device(model)
    if isinstance(image, torch.Tensor) and image.device != device:
        raise ValueError('image on %s, model on %s' % (image.device, device))
    return as_tensor(image, device)


def segment_color2d_slic_features_model_graphcut(
        image, model_pipeline, dict_features, sp_size=30,
        sp_regul=0.2, gc_regul=1.0, gc_edge_type='model', debug_visual=None,
        sp_compat=False, connectivity=True, device='cuda'):
    """Segment one image with a fitted model.

    The work runs on the device of ``model_pipeline``, a :class:`ClassModel`
    or a trained :class:`Classifier`; a numpy image is moved there, a tensor
    image must already be there.  A classifier's result is relabelled by its
    ``classes_``.  Any other model with a numpy ``predict_proba`` and
    ``classes_`` (an sklearn-style estimator) takes the reference's generic
    route: the features go to the host for its ``predict_proba``, and the
    MRF runs on the image's device (``device`` for a numpy image), on the
    enforced labels whatever ``connectivity`` says.

    :param image: (H, W, 3) float image, numpy or tensor
    :returns: (segm (H, W) int ndarray, segm_soft (H, W, C) ndarray)
    """
    if sp_compat:
        raise NotImplementedError('sp_compat (skimage-compat SLIC) comes '
                                  'with the RG2Sp slice (ROADMAP.md)')
    if not isinstance(model_pipeline, (ClassModel, Classifier)):
        return _segment_duck_typed(image, model_pipeline, dict_features,
                                   sp_size, sp_regul, gc_regul, gc_edge_type,
                                   debug_visual, device)
    with stage_range('upload'):
        image = _to_model_device(image, model_pipeline)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    if isinstance(model_pipeline, Classifier):
        return _segment_classif(image, model_pipeline, cfg, m, dict_features,
                                gc_regul, gc_edge_type, connectivity,
                                debug_visual)
    segm, segm_soft, labels, proba, graph_labels = _segment_with_model_core(
        image, model_pipeline, cfg=cfg,
        feats_spec=_features_spec(dict_features), gc_regul=float(gc_regul),
        gc_edge_type=gc_edge_type, compactness=m, connectivity=connectivity)
    if debug_visual is not None:
        debug_visual['slic'] = labels.cpu().numpy()
        debug_visual['proba'] = proba.cpu().numpy()
    if connectivity:
        return _fetch_reconstruct(labels, proba, graph_labels, cfg)
    # raw labels may hold out-of-window pixels: the device lookup holds
    return segm.cpu().numpy(), segm_soft.cpu().numpy()


def _segment_duck_typed(image, model, dict_features, sp_size, sp_regul,
                        gc_regul, gc_edge_type, debug_visual, device):
    """The generic route: SLIC and features on the device, the model's
    numpy ``predict_proba`` on the host, the MRF on the device, and the
    upsampling on the host."""
    if not hasattr(model, 'predict_proba'):
        raise AttributeError('%r has no predict_proba' % type(model).__name__)
    image = as_tensor(image, device)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    labels, features, _counts, centers = _slic_features_core(
        image, cfg, _features_spec(dict_features), m)
    proba = np.asarray(model.predict_proba(
        np.nan_to_num(features.cpu().numpy())), np.float32)
    graph_labels = graphcut.segment_graph_cut_general(
        labels, torch.as_tensor(proba, device=image.device), cfg.n_segments,
        image=image.to(torch.float32), features=features,
        gc_regul=float(gc_regul), edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers).cpu().numpy()
    labels_np = labels.cpu().numpy()
    segm = np.asarray(model.classes_)[graph_labels][labels_np]
    if debug_visual is not None:
        debug_visual['slic'] = labels_np
        debug_visual['proba'] = proba
    return segm, proba[labels_np]


def _segment_classif(image, classif, cfg, compactness, dict_features,
                     gc_regul, gc_edge_type, connectivity, debug_visual):
    labels, features, proba, graph_labels = _segment_with_classif_core(
        image, classif, cfg=cfg, feats_spec=_features_spec(dict_features),
        gc_regul=float(gc_regul), gc_edge_type=gc_edge_type,
        compactness=compactness, connectivity=connectivity)
    with stage_range('fetch'):
        if connectivity:
            segm_dense, segm_soft = _fetch_reconstruct(labels, proba,
                                                       graph_labels, cfg)
        else:
            # raw labels may hold out-of-window pixels: one device lookup
            # of [graph label, proba]
            up = grid_lookup(torch.cat(
                [graph_labels[:, None].to(torch.float32), proba], dim=-1),
                labels, cfg).cpu().numpy()
            segm_dense = up[..., 0].astype(np.int64)
            segm_soft = up[..., 1:]
        if debug_visual is not None:
            debug_visual['slic'] = labels.cpu().numpy()
            debug_visual['features'] = features.cpu().numpy()
            debug_visual['proba'] = proba.cpu().numpy()
    return np.asarray(classif.classes_)[segm_dense], segm_soft


def compute_color2d_superpixels_features(image, dict_features, sp_size=30,
                                         sp_regul=0.2, device='cuda'):
    """SLIC + per-superpixel features.

    :returns: (labels (H, W) int32 ndarray, features (K, F) ndarray) where K
        is the static superpixel capacity; empty slots are zero rows
    """
    if sp_regul <= 0:
        raise ValueError('slic. regularisation must be positive')
    image = as_tensor(image, device)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    labels, features, _counts, _centers = _slic_features_core(
        image, cfg, _features_spec(dict_features), m)
    return labels.cpu().numpy(), torch.nan_to_num(features).cpu().numpy()


def wrapper_compute_color2d_slic_features_labels(img_annot, sp_size, sp_regul,
                                                 dict_features,
                                                 label_purity=0.9,
                                                 device='cuda'):
    """SLIC, features and superpixel labels of one annotated image for the
    supervised training: each superpixel takes the annotation label it
    overlaps most, or -1 where that covers less than ``label_purity`` of it,
    where the annotation is negative or where it is empty.

    :param img_annot: (image, annotation) pair
    :returns: (slic ndarray, features ndarray, labels ndarray)
    """
    from pyimsegm_tpu_torch import labeling

    image, annot = img_annot
    image = as_tensor(image, device)
    annot = np.asarray(annot).astype(int)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    labels_map, features, counts, _centers = _slic_features_core(
        image, cfg, _features_spec(dict_features), m)
    labels_map = labels_map.cpu().numpy()
    neg_label = annot.max() + 1 if (annot < 0).any() else None
    if neg_label is not None:
        annot[annot < 0] = neg_label
    hist = labeling.histogram_regions_labels_norm(
        labels_map, annot, nb_labels=annot.max() + 1)
    lbs = np.argmax(hist, axis=1)
    purity = np.max(hist, axis=1)
    if neg_label is not None:
        lbs[lbs == neg_label] = -1
    lbs[purity < label_purity] = -1
    lbs[counts.cpu().numpy() == 0] = -1
    return labels_map, np.nan_to_num(features.cpu().numpy()), lbs


def pipe_color2d_slic_features_model_graphcut(
        image, nb_classes, dict_features, sp_size=30, sp_regul=0.2,
        pca_coef=None, use_scaler=True, estim_model='GMM', gc_regul=1.0,
        gc_edge_type='model', seed=0, debug_visual=None, device='cuda'):
    """Unsupervised single-image pipeline: SLIC -> features -> class model
    fitted on the image -> MRF regularisation.

    :param image: (H, W, 3) image; a tensor runs on its device, anything
        else on ``device``
    :param seed: seed of the model fit's ``torch.Generator``
    :returns: (segm (H, W) int ndarray, segm_soft (H, W, C) float ndarray)
    """
    image = as_tensor(image, device)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    segm, segm_soft, labels, features, proba, model, graph_labels = \
        _pipe_unsup_core(
            image, cfg=cfg, feats_spec=_features_spec(dict_features),
            nb_classes=nb_classes, estim_model=estim_model, pca_coef=pca_coef,
            use_scaler=use_scaler, gc_regul=float(gc_regul),
            gc_edge_type=gc_edge_type, compactness=m, seed=seed)
    if debug_visual is not None:
        debug_visual['slic'] = labels.cpu().numpy()
        debug_visual['features'] = features.cpu().numpy()
        debug_visual['proba'] = proba.cpu().numpy()
        debug_visual['model'] = model
        return segm.cpu().numpy(), segm_soft.cpu().numpy()
    return _fetch_reconstruct(labels, proba, graph_labels, cfg)


def estim_model_classes_group(list_images, nb_classes, dict_features,
                              sp_size=30, sp_regul=0.2, use_scaler=True,
                              pca_coef=None, model_type='GMM', seed=0,
                              device='cuda'):
    """Fit one class model over the superpixels of several images.

    :returns: (ClassModel on the images' device, list of per-image (K, F)
        feature ndarrays)
    """
    feats_spec = _features_spec(dict_features)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    all_features, all_masks, list_features = [], [], []
    for image in list_images:
        image = as_tensor(image, device)
        cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
        _labels, features, counts, _centers = _slic_features_core(
            image, cfg, feats_spec, m)
        all_features.append(features)
        all_masks.append((counts > 0).to(torch.float32))
        list_features.append(torch.nan_to_num(features).cpu().numpy())
    model = estim_class_model(
        torch.nan_to_num(torch.cat(all_features)), nb_classes, model_type,
        pca_coef, use_scaler, sample_weight=torch.cat(all_masks), seed=seed)
    return model, list_features


def _pipe_gray3d_core(image, *, cfg, feats_spec, nb_classes, estim_model,
                      gc_regul, compactness, seed=0):
    """Supervoxels -> grid reductions -> features standardised over the
    non-empty supervoxels -> class model fitted on them -> MRF on the
    supervoxel grid -> lookup, all on the volume's device.

    :returns: (segm (Z, H, W) int32, labels (Z, H, W) int32, features
        (K, F), model)
    """
    k = cfg.n_segments
    with stage_range('slic'):
        labels = slic3d.slic3d_segment(image, cfg, compactness)
    with stage_range('counts'):
        counts, centers = slic3d.grid3d_geometry(labels, cfg)
        mask = (counts > 0).to(torch.float32)
    with stage_range('features'):
        features, _ = descriptors.compute_selected_features_gray3d(
            image, labels.reshape(-1), k, dict(feats_spec),
            grid_ctx3d=(labels, cfg))
        n = torch.clamp_min(torch.sum(mask), 1.0)
        mu = torch.sum(features * mask[:, None], 0) / n
        sd = torch.sqrt(torch.sum(((features - mu) ** 2) * mask[:, None], 0)
                        / n)
        features = (features - mu) / torch.clamp_min(sd, 1e-12)
    with stage_range('fit'):
        model = estim_class_model(features, nb_classes, estim_model,
                                  sample_weight=mask, seed=seed)
    with stage_range('predict_proba'):
        proba = model.predict_proba(features)
    # the edges and the MRF solve are ranges of their own in graphcut
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, k, image=image, features=features,
        gc_regul=float(gc_regul), edge_type='model', grid_ctx3d=(labels, cfg),
        centers=centers)
    with stage_range('lookup'):
        segm = slic3d.grid3d_lookup(graph_labels, labels, cfg)
    return segm, labels, features, model


def pipe_gray3d_slic_features_model_graphcut(
        image, nb_classes, dict_features, spacing=(12, 1, 1), sp_size=15,
        sp_regul=0.2, gc_regul=0.1, estim_model='GMM', seed=0,
        device='cuda', debug_visual=None):
    """Unsupervised gray-volume pipeline: 3D SLIC supervoxels -> gray
    features (standardised) -> class model fitted on the volume -> MRF on
    the supervoxel grid.

    :param image: (Z, H, W) gray volume; a tensor runs on its device,
        anything else on ``device``
    :param spacing: physical voxel spacing per axis
    :param seed: seed of the model fit's ``torch.Generator``
    :param debug_visual: optional dict, filled with the SLIC labels, the
        standardised features and the fitted model
    :returns: segm (Z, H, W) int64 ndarray
    """
    with stage_range('upload'):
        image = as_tensor(image, device).to(torch.float32)
    cfg = slic3d.slic3d_config(tuple(image.shape), sp_size, spacing)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    segm, labels, features, model = _pipe_gray3d_core(
        image, cfg=cfg, feats_spec=_features_spec(dict_features),
        nb_classes=nb_classes, estim_model=estim_model,
        gc_regul=float(gc_regul), compactness=m, seed=seed)
    if debug_visual is not None:
        debug_visual['slic'] = labels.cpu().numpy()
        debug_visual['features'] = features.cpu().numpy()
        debug_visual['model'] = model
    # class ids fit in a byte: fetch 1 B per voxel instead of 4
    with stage_range('fetch'):
        small = segm.to(torch.uint8) if nb_classes <= 0xff else segm
        return small.cpu().numpy().astype(np.int64)


def train_classif_color2d_slic_features(list_images, list_annots,
                                        dict_features, sp_size=30,
                                        sp_regul=0.2, clf_name='RandForest',
                                        label_purity=0.9,
                                        feature_balance='unique',
                                        pca_coef=None, nb_classif_search=1,
                                        nb_hold_out=CROSS_VAL_LEAVE_OUT,
                                        seed=0, device='cuda'):
    """Supervised training over annotated images: each superpixel takes the
    annotation label that covers at least ``label_purity`` of it (else it is
    dropped), the dataset is balanced, and a classifier is searched and
    fitted on ``device`` (the superpixels and features of a tensor image
    come from its own device).

    :returns: (Classifier, list of SLIC label maps, list of (K, F) feature
        arrays, list of (K,) superpixel labels, -1 = dropped)
    """
    from pyimsegm_tpu_torch import classification, labeling

    if len(list_images) != len(list_annots):
        raise ValueError('images (%i) vs annotations (%i) mismatch'
                         % (len(list_images), len(list_annots)))
    feats_spec = _features_spec(dict_features)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    list_slic, list_features, list_labels = [], [], []
    for image, annot in zip(list_images, list_annots):
        image = as_tensor(image, device)
        annot = np.asarray(annot).astype(int)
        if tuple(image.shape[:2]) != annot.shape[:2]:
            raise ValueError('image %r and annot %r should match'
                             % (tuple(image.shape), annot.shape))
        cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
        labels_map, features, counts, _centers = _slic_features_core(
            image, cfg, feats_spec, m)
        labels_map = labels_map.cpu().numpy()
        counts = counts.cpu().numpy()
        neg_label = annot.max() + 1 if (annot < 0).any() else None
        if neg_label is not None:
            annot[annot < 0] = neg_label
        hist = labeling.histogram_regions_labels_norm(
            labels_map, annot, nb_labels=annot.max() + 1)
        k = counts.shape[0]
        if hist.shape[0] < k:
            # the highest grid labels can be empty (merged away by the
            # min-size pass): pad to the static capacity
            hist = np.vstack([hist,
                              np.zeros((k - hist.shape[0], hist.shape[1]))])
        lbs = np.argmax(hist, axis=1)
        purity = np.max(hist, axis=1)
        if neg_label is not None:
            lbs[lbs == neg_label] = -1
        lbs[purity < label_purity] = -1
        lbs[counts == 0] = -1                       # empty slots
        list_slic.append(labels_map)
        list_features.append(torch.nan_to_num(features).cpu().numpy())
        list_labels.append(lbs)

    features, labels, sizes = \
        classification.convert_set_features_labels_2_dataset(
            dict(enumerate(list_features)), dict(enumerate(list_labels)),
            balance_type=feature_balance, drop_labels=[-1], device=device)
    features = np.nan_to_num(features)
    cv = (classification.CrossValidateGroups(sizes, nb_hold_out=nb_hold_out)
          if len(sizes) > nb_hold_out * 5 else 10)
    classif, _ = classification.create_classif_search_train_export(
        clf_name, features, labels, pca_coef=pca_coef, cross_val=cv,
        nb_search_iter=nb_classif_search, seed=seed, device=device)
    return classif, list_slic, list_features, list_labels
