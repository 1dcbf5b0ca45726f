"""Public segmentation pipelines (port of ``pyimsegm_tpu.pipelines``).

Ported so far: :func:`segment_color2d_slic_features_model_graphcut` with a
fitted :class:`ClassModel` and a single ``'color'`` key of plain moments
(mean / std / energy), with ``connectivity=True`` (the default) or False.
That path is SLIC -> [connectivity enforcement + min-size merge + moments
re-reduce] -> GMM ``predict_proba`` -> MRF on the 25-neighbour superpixel
grid -> upsampling.  The other options raise ``NotImplementedError`` naming
the slice of ROADMAP.md that brings them.
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.models.class_model import ClassModel
from pyimsegm_tpu_torch.ops import graphcut
from pyimsegm_tpu_torch.ops import grid as grid_ops
from pyimsegm_tpu_torch.ops import slic as slic_ops
from pyimsegm_tpu_torch.ops.grid import grid_lookup

_MOMENT_FLAGS = ('mean', 'std', 'energy')


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
    safe = torch.clamp_min(counts[:, None], 1.0)
    mean = msums[:, :3] / safe
    energy = msums[:, 3:6] / safe
    blocks = {'mean': mean,
              'std': torch.sqrt(torch.clamp_min(energy - mean * mean, 0.0)),
              'energy': energy}
    return torch.cat([blocks[f] for f in _MOMENT_FLAGS if f in flags], dim=-1)


def _slic_features_core(image, cfg, feats_spec, compactness, slico=False,
                        n_iter=slic_ops.DEFAULT_SLIC_ITERS,
                        connectivity=True):
    """SLIC + per-superpixel features.

    With ``connectivity`` the SLIC labels are enforced (every superpixel one
    4-connected region, superpixels below half a tile merged into a
    neighbour), seeded by the centroids of the final SLIC pass, and the
    geometry and colour moments are re-reduced over the final labels.

    :param image: (H, W, 3) float tensor
    :returns: (labels (H, W) i32, features (K, F), counts (K,),
        centres (K, 2))
    """
    if slico:
        raise NotImplementedError('SLICO comes with the fitting slice '
                                  '(ROADMAP.md)')
    fuse_key = None if image.ndim != 3 else _fusable_color_spec(feats_spec)
    if fuse_key != 'color':
        raise NotImplementedError(
            'only a single "color" key of mean/std/energy is ported; other '
            'feature specs come with the fitting slice (ROADMAP.md)')
    # the moments are of the raw RGB float image, not of Lab
    img_f = image.to(torch.float32)
    flags = dict(feats_spec)[fuse_key]
    labels, counts, centers, msums = slic_ops.slic_segment_with_features(
        image, img_f, cfg, compactness, n_iter=n_iter)
    if connectivity:
        labels, sums = grid_ops.enforce_minsize_with_moments(
            labels, cfg, int(0.5 * cfg.step * cfg.step), centers, img_f)
        counts = sums[:, 6]
        centers = sums[:, 7:9] / torch.clamp_min(counts[:, None], 1.0)
        msums = sums[:, :6]
    return labels, _moment_features(msums, counts, flags), counts, centers


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


def _model_device(model):
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
    if not isinstance(model, ClassModel):
        raise NotImplementedError('classifiers come with the supervised '
                                  'slice (ROADMAP.md)')
    device = _model_device(model)
    if isinstance(image, torch.Tensor):
        if image.device != device:
            raise ValueError('image on %s, model on %s'
                             % (image.device, device))
        return image
    return torch.as_tensor(np.asarray(image), device=device)


def segment_color2d_slic_features_model_graphcut(
        image, model_pipeline, dict_features, sp_size=30,
        sp_regul=0.2, gc_regul=1.0, gc_edge_type='model', debug_visual=None,
        sp_compat=False, connectivity=True):
    """Segment one image with a fitted model.

    The work runs on the device of ``model_pipeline``; a numpy image is
    moved there, a tensor image must already be there.

    :param image: (H, W, 3) float image, numpy or tensor
    :returns: (segm (H, W) int32 ndarray, segm_soft (H, W, C) ndarray)
    """
    if sp_compat:
        raise NotImplementedError('sp_compat comes with a later slice '
                                  '(ROADMAP.md)')
    image = _to_model_device(image, model_pipeline)
    cfg = slic_ops.slic_config(image.shape[0], image.shape[1], sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
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
