"""MRF regularisation of superpixel class probabilities.

Port of the grid branch of ``pyimsegm_tpu.ops.graphcut``: clipped
``|log p|`` unary costs, the Potts / matrix pairwise costs, and the dense
25-neighbour grid solve (:func:`pyimsegm_tpu_torch.ops.grid.solve_mrf_grid`).
"""

import numpy as np
import torch

#: minimal class probability in the unary term
MIN_UNARY_PROB = 0.01
#: maximal pairwise cost
MAX_PAIRWISE_COST = 1e5
#: max edge weight; min is its inverse
MIN_MAX_EDGE_WEIGHT = 1e3


def compute_unary_cost(proba, min_prob=MIN_UNARY_PROB):
    """``|-log(clip(p, 0.01, 0.99))|``."""
    p = torch.clamp(proba, min_prob, 1.0 - min_prob)
    return torch.abs(-torch.log(p))


def create_pairwise_matrix_uniform(gc_regul, nb_classes):
    """Uniform Potts matrix with zero diagonal."""
    return gc_regul * (np.ones((nb_classes, nb_classes)) - np.eye(nb_classes))


def create_pairwise_matrix(gc_regul, nb_classes):
    """Scalar -> uniform; (C, C) matrix -> shifted by its min; list of
    ((i, j), w) -> the uniform matrix with those entries set."""
    if isinstance(gc_regul, (np.ndarray, torch.Tensor)) and gc_regul.ndim == 2:
        gc_regul = np.asarray(gc_regul)
        if gc_regul.shape[0] != nb_classes or gc_regul.shape[1] != nb_classes:
            raise ValueError('GC regul matrix %r should match classes (%i)'
                             % (gc_regul.shape, nb_classes))
        return gc_regul - np.min(gc_regul)
    if isinstance(gc_regul, (list, tuple)):
        pairwise = np.ones((nb_classes, nb_classes)) - np.eye(nb_classes)
        for (i, j), w in gc_regul:
            pairwise[i, j] = w
            pairwise[j, i] = w
        return pairwise
    return create_pairwise_matrix_uniform(float(gc_regul), nb_classes)


def compute_pairwise_cost(gc_regul, nb_classes, max_cost=MAX_PAIRWISE_COST):
    pairwise = create_pairwise_matrix(gc_regul, nb_classes)
    return np.minimum(np.asarray(pairwise, np.float64), max_cost)


def segment_graph_cut_general(labels, proba, num_segments, image=None,
                              features=None, gc_regul=1.0, edge_type='model',
                              edge_cost=1.0, grid_ctx=None, centers=None,
                              grid_ctx3d=None):
    """MRF stage on the superpixel graph; only the grid branch is ported.

    :param labels: (H, W) superpixel map
    :param proba: (K, C) class probabilities
    :param grid_ctx: (labels2d, SlicConfig) of grid-structured SLIC labels
    :returns: (K,) int32 class per superpixel
    """
    unary = compute_unary_cost(proba)
    if np.isscalar(gc_regul) and gc_regul <= 0:
        return torch.argmin(unary, dim=-1).to(torch.int32)
    if grid_ctx is None:
        raise NotImplementedError(
            'the edge-list MRF (generic labels, 3D grids) comes with the '
            'RG2Sp and 3D slices of ROADMAP.md')
    pairwise = compute_pairwise_cost(gc_regul, proba.shape[1])
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    labels2d, cfg = grid_ctx
    mean_color = None
    if edge_type == 'color':
        img = image.to(torch.float32)
        img = torch.where(torch.amax(img) > 1.0, img / 255.0, img)
        ones = torch.ones(img.shape[:2] + (1,), dtype=torch.float32,
                          device=img.device)
        csum = grid_ops.grid_segment_sum(torch.cat([img, ones], -1),
                                         labels2d, cfg)
        mean_color = csum[:, :-1] / torch.clamp_min(csum[:, -1:], 1.0)
    wgrid = grid_ops.grid_edge_weights(
        labels2d, cfg, proba=proba, features=features, mean_color=mean_color,
        edge_type=edge_type, centers=centers) * edge_cost
    return grid_ops.solve_mrf_grid(
        unary, wgrid, torch.as_tensor(pairwise, dtype=torch.float32,
                                      device=unary.device), cfg)
