"""MRF regularisation of superpixel class probabilities.

Port of the grid branches of ``pyimsegm_tpu.ops.graphcut``: clipped
``|log p|`` unary costs, the Potts / matrix pairwise costs, the dense
25-neighbour grid solve of 2D SLIC superpixels
(:func:`pyimsegm_tpu_torch.ops.grid.solve_mrf_grid`), and for 3D SLIC
supervoxels the edge list with every edge type
(:func:`compute_edge_weights`) folded into the dense 125-neighbour solve
(:func:`pyimsegm_tpu_torch.ops.slic3d.solve_mrf_grid3d`).
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.utils.device import stage_range

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


def compute_edge_weights(labels, num_segments, image=None, features=None,
                         proba=None, edge_type='', centers=None,
                         grid_cfg3d=None):
    """Edge list + weights of 3D supervoxels, every edge type of the
    reference.

    :param labels: (Z, H, W) supervoxel labels on the grid of
        ``grid_cfg3d`` (a ``Slic3DConfig``)
    :param edge_type: '' | 'spatial' | 'color' | 'features' |
        'model[_l1|_l2|_lT]'
    :param centers: optional (K, 3) supervoxel centres (reduced from the
        labels when not given)
    :returns: (edges (8K, 2) int32, weights (8K,), valid (8K,) bool)
    """
    from pyimsegm_tpu_torch.ops import graph as graph_ops
    from pyimsegm_tpu_torch.ops import segment_stats
    if labels.ndim != 3 or grid_cfg3d is None:
        raise NotImplementedError(
            'edge lists of 2D or non-grid labels come with the RG2Sp slice '
            '(ROADMAP.md)')
    edges, valid = graph_ops.adjacency_edges_3d(labels, num_segments,
                                                grid_cfg3d)
    if edge_type.startswith('model'):
        if proba is None:
            raise ValueError('"proba" is required for edge_type=model')
        metric = edge_type.split('_')[-1] if '_' in edge_type else 'lT'
        weights = graph_ops.edge_model_weights(edges, valid, proba, metric)
    elif edge_type == 'color':
        if image is None:
            raise ValueError('"image" is required for edge_type=color')
        img = image.to(torch.float32)
        img = torch.where(torch.amax(img) > 1.0, img / 255.0, img)
        mean_color = segment_stats.segment_mean_std_energy(
            img.reshape(-1, img.shape[-1]), labels.reshape(-1), num_segments,
            flags=('mean',))['mean']
        weights = graph_ops.edge_vector_weights(edges, valid, mean_color, 'l1')
    elif edge_type == 'features':
        if features is None:
            raise ValueError('"features" is required for edge_type=features')
        mu = torch.mean(features, dim=0)
        sd = torch.clamp_min(torch.std(features, dim=0, correction=0), 1e-12)
        weights = graph_ops.edge_vector_weights(edges, valid,
                                                (features - mu) / sd, 'l2')
    else:
        weights = torch.ones(edges.shape[0], dtype=torch.float32,
                             device=labels.device)

    if edge_type in ('model', 'model_l1', 'model_l2', 'model_lT',
                     'features', 'color', 'spatial'):
        if centers is None:
            centers = graph_ops.superpixel_centers(labels, num_segments,
                                                   ndim=3)
        spatial = graph_ops.compute_spatial_dist(centers, edges, valid,
                                                 relative=True)
        weights = weights / torch.clamp_min(spatial, 1e-12)

    weights = torch.clamp(weights, 1.0 / MIN_MAX_EDGE_WEIGHT,
                          MIN_MAX_EDGE_WEIGHT)
    return edges, torch.where(valid, weights, 0.0), valid


def segment_graph_cut_general(labels, proba, num_segments, image=None,
                              features=None, gc_regul=1.0, edge_type='model',
                              edge_cost=1.0, grid_ctx=None, centers=None,
                              grid_ctx3d=None):
    """MRF stage on the superpixel graph; the grid branches are ported.

    :param labels: (H, W) superpixel map or (Z, H, W) supervoxel volume
    :param proba: (K, C) class probabilities
    :param grid_ctx: (labels2d, SlicConfig) of grid-structured SLIC labels
    :param grid_ctx3d: (labels3d, Slic3DConfig) of SLIC supervoxels: the
        edge list with its weights, folded into the 125-neighbour grid
    :param centers: optional (K, 2) or (K, 3) superpixel centres
    :returns: (K,) int32 class per superpixel
    """
    unary = compute_unary_cost(proba)
    if np.isscalar(gc_regul) and gc_regul <= 0:
        return torch.argmin(unary, dim=-1).to(torch.int32)
    if grid_ctx is None and grid_ctx3d is None:
        raise NotImplementedError(
            'the edge-list MRF of generic labels comes with the RG2Sp slice '
            '(ROADMAP.md)')
    pairwise = torch.as_tensor(compute_pairwise_cost(gc_regul, proba.shape[1]),
                               dtype=torch.float32, device=unary.device)
    if grid_ctx is None:
        from pyimsegm_tpu_torch.ops import slic3d as slic3d_ops
        _labels3d, cfg3 = grid_ctx3d
        with stage_range('edges'):
            edges, weights, valid = compute_edge_weights(
                labels, num_segments, image=image, features=features,
                proba=proba, edge_type=edge_type, centers=centers,
                grid_cfg3d=cfg3)
        with stage_range('mrf'):
            wgrid = slic3d_ops.wgrid3d_from_edges(edges, valid,
                                                  weights * edge_cost, cfg3)
            return slic3d_ops.solve_mrf_grid3d(unary, wgrid, pairwise, cfg3)
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
    with stage_range('edges'):
        wgrid = grid_ops.grid_edge_weights(
            labels2d, cfg, proba=proba, features=features,
            mean_color=mean_color, edge_type=edge_type,
            centers=centers) * edge_cost
    with stage_range('mrf'):
        return grid_ops.solve_mrf_grid(unary, wgrid, pairwise, cfg)
