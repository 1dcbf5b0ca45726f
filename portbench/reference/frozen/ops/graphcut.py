"""MRF regularisation of superpixel class probabilities (frozen from the
port's ``ops/graphcut``): clipped ``|log p|`` unary costs, the Potts
pairwise cost, 'model' edge weights, and the dense solves of
``E(l) = sum_i U_i(l_i) + sum_e w_e P(l_a, l_b)``: the 25-neighbour grid
of 2D SLIC superpixels (:func:`portbench.reference.frozen.ops.grid.
solve_mrf_grid`) and the 125-neighbour one of 3D SLIC supervoxels
(:func:`portbench.reference.frozen.ops.slic3d.solve_mrf_grid3d`).
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


def compute_pairwise_cost(gc_regul, nb_classes, max_cost=MAX_PAIRWISE_COST):
    """The uniform Potts matrix ``gc_regul`` off the diagonal, capped."""
    pairwise = float(gc_regul) * (np.ones((nb_classes, nb_classes))
                                  - np.eye(nb_classes))
    return np.minimum(np.asarray(pairwise, np.float64), max_cost)


def edge_weights_3d(labels, num_segments, proba, centers, cfg3):
    """'model' edge list + weights of SLIC supervoxels: the grid's conn6
    edges, ``exp(-dist / (2 * std(dist)**2))`` of the largest squared
    proba difference, over the relative centre distance, clipped.

    :returns: (edges (8K, 2) int32, weights (8K,), valid (8K,) bool)
    """
    from portbench.reference.frozen.ops import graph as graph_ops
    edges, valid = graph_ops.adjacency_edges_3d(labels, num_segments, cfg3)
    weights = graph_ops.edge_model_weights(edges, valid, proba, 'lT')
    spatial = graph_ops.compute_spatial_dist(centers, edges, valid,
                                             relative=True)
    weights = weights / torch.clamp_min(spatial, 1e-12)
    weights = torch.clamp(weights, 1.0 / MIN_MAX_EDGE_WEIGHT,
                          MIN_MAX_EDGE_WEIGHT)
    return edges, torch.where(valid, weights, 0.0), valid


def segment_graph_cut_general(labels, proba, num_segments, gc_regul,
                              centers, grid_ctx=None, grid_ctx3d=None):
    """MRF stage with 'model' edges on the grid of the SLIC labels.

    :param labels: (H, W) superpixel map or (Z, H, W) supervoxel volume
    :param proba: (K, C) class probabilities
    :param gc_regul: the Potts weight, > 0
    :param centers: (K, 2) or (K, 3) superpixel centres
    :param grid_ctx: (labels2d, SlicConfig) of grid-structured SLIC labels
    :param grid_ctx3d: (labels3d, Slic3DConfig) of SLIC supervoxels: the
        edge list with its weights, folded into the 125-neighbour grid
    :returns: (K,) int32 class per superpixel
    """
    if not gc_regul > 0:
        raise ValueError('the reference solves gc_regul > 0 only')
    unary = compute_unary_cost(proba)
    pairwise = torch.as_tensor(compute_pairwise_cost(gc_regul, proba.shape[1]),
                               dtype=torch.float32, device=unary.device)
    if grid_ctx is None:
        from portbench.reference.frozen.ops import slic3d as slic3d_ops
        _labels3d, cfg3 = grid_ctx3d
        edges, weights, valid = edge_weights_3d(labels, num_segments, proba,
                                                centers, cfg3)
        wgrid = slic3d_ops.wgrid3d_from_edges(edges, valid, weights, cfg3)
        return slic3d_ops.solve_mrf_grid3d(unary, wgrid, pairwise, cfg3)
    from portbench.reference.frozen.ops import grid as grid_ops
    labels2d, cfg = grid_ctx
    wgrid = grid_ops.grid_edge_weights(labels2d, cfg, proba=proba,
                                       centers=centers)
    return grid_ops.solve_mrf_grid(unary, wgrid, pairwise, cfg)
