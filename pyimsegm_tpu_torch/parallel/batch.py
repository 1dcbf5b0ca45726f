"""Batched execution of the segmentation pipeline on one card (port of
``pyimsegm_tpu.parallel.batch``).

The JAX package ``vmap``s the per-image pipeline; here the batch is a loop
over the leading dimension on the current stream, each image through the
same kernels as the single-image call.  A device mesh comes with the
multi-GPU slice of ROADMAP.md.
"""

import torch

from pyimsegm_tpu_torch import pipelines
from pyimsegm_tpu_torch.ops import graphcut
from pyimsegm_tpu_torch.ops import slic as slic_ops
from pyimsegm_tpu_torch.ops.grid import grid_lookup


def _segment_one(image, model, *, cfg, feats_spec, gc_regul, gc_edge_type,
                 compactness):
    """One image: enforced SLIC + features, GMM proba, grid MRF, and one
    lookup that upsamples the hard labels and the soft proba together."""
    labels, features, _counts, centers = pipelines._slic_features_core(
        image, cfg, feats_spec, compactness)
    proba = model.predict_proba(features)
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=image.to(torch.float32),
        features=features, gc_regul=gc_regul, edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers)
    table = torch.cat([graph_labels[:, None].to(torch.float32), proba],
                      dim=-1)
    up = grid_lookup(table, labels, cfg)
    return up[..., 0].to(torch.int32), up[..., 1:]


def segment_images_batch(images, model, dict_features, sp_size=30,
                         sp_regul=0.2, gc_regul=1.0, gc_edge_type='model',
                         mesh=None):
    """Segment a stack of same-shape images with a fitted model, on the
    model's device.

    :param images: (B, H, W, 3) array or tensor
    :param mesh: not supported yet (multi-GPU slice)
    :returns: (segms (B, H, W) int32, probs (B, H, W, C) f32) numpy arrays
    """
    if mesh is not None:
        raise NotImplementedError('a device mesh comes with the multi-GPU '
                                  'slice (ROADMAP.md)')
    images = pipelines._to_model_device(images, model).to(torch.float32)
    h, w = images.shape[1:3]
    cfg = slic_ops.slic_config(h, w, sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    spec = pipelines._features_spec(dict_features)
    outs = [_segment_one(img, model, cfg=cfg, feats_spec=spec,
                         gc_regul=float(gc_regul), gc_edge_type=gc_edge_type,
                         compactness=m) for img in images]
    segms = torch.stack([o[0] for o in outs])
    probs = torch.stack([o[1] for o in outs])
    return segms.cpu().numpy(), probs.cpu().numpy()
