"""GraphCut-stage API under the reference's names (port of
``pyimsegm_tpu.graph_cuts``): class-model estimation from
``models/class_model``, the MRF solvers and cost constructions from
``ops/graphcut``, the host list helpers of the reference, and
``insert_gc_debug_images``, which draws with ``utils/drawing``.
"""

import logging

import numpy as np
import torch

from pyimsegm_tpu_torch.models.class_model import (  # noqa: F401
    ClassModel, estim_class_model)
from pyimsegm_tpu_torch.models.gmm import (  # noqa: F401  (re-export)
    gmm_fit_from_labels)
from pyimsegm_tpu_torch.models.otsu import (  # noqa: F401
    compute_multivariate_otsu)
from pyimsegm_tpu_torch.ops.graphcut import (  # noqa: F401
    MAX_PAIRWISE_COST, MIN_UNARY_PROB, compute_edge_weights,
    compute_pairwise_cost, compute_pairwise_cost_from_transitions,
    compute_unary_cost, count_label_transitions_connected_segments,
    create_pairwise_matrix, create_pairwise_matrix_uniform, mrf_energy,
    solve_mrf)
from pyimsegm_tpu_torch.ops.graphcut import \
    segment_graph_cut_general as _segment_graph_cut_core
from pyimsegm_tpu_torch.utils.device import as_tensor, host_array

#: alias kept for the reference's name
compute_multivarian_otsu = compute_multivariate_otsu


def compute_spatial_dist(centres, edges, relative=False):
    """Distance between adjacent superpixel centres (host list API)."""
    centres = np.asarray(centres, float)
    edges = np.asarray(edges, int)
    d = centres[edges[:, 0]] - centres[edges[:, 1]]
    dist = np.sqrt(np.sum(d * d, axis=1))
    if relative:
        dist = dist / np.mean(dist)
    return dist


def get_vertexes_edges(segments):
    """(vertices, edges) of the superpixel adjacency."""
    from pyimsegm_tpu_torch.superpixels import \
        make_graph_segm_connect_grid2d_conn4
    return make_graph_segm_connect_grid2d_conn4(np.asarray(segments))


def estim_gmm_params(features, prob):
    """Mean / covariance / weights from soft responsibilities (host)."""
    features = np.asarray(features, float)
    prob = np.asarray(prob, float)
    weights = prob.mean(axis=0)
    means, covars = [], []
    for i in range(prob.shape[1]):
        w = prob[:, i:i + 1]
        tot = max(w.sum(), 1e-12)
        mu = (features * w).sum(axis=0) / tot
        diff = features - mu
        cov = (diff * w).T @ diff / tot
        means.append(mu)
        covars.append(cov)
    return {'weights': weights.tolist(), 'means': np.array(means),
            'covars': np.array(covars)}


def estim_class_model_gmm(features, nb_classes, init='kmeans',
                          device='cuda'):
    """GMM over features, k-means seeded by default; returns a model with
    ``predict_proba``."""
    model_name = 'GMM_kmeans' if init == 'kmeans' else 'GMM'
    return estim_class_model(features, nb_classes, estim_model=model_name,
                             use_scaler=False, device=device)


def estim_class_model_kmeans(features, nb_classes, init_type='k-means++',
                             max_iter=99, device='cuda'):
    """k-means clustering + a one-shot Gaussian fit per cluster.

    :returns: (model with ``predict_proba``, (N,) numpy cluster labels)
    """
    from pyimsegm_tpu_torch.models import gmm as gmm_mod
    x = as_tensor(np.asarray(features, np.float32), device)
    w = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    gen = torch.Generator(device=x.device).manual_seed(0)
    if init_type == 'quantiles':
        centers = gmm_mod.quantile_init_centers(x, nb_classes)
        _, y = gmm_mod.kmeans_fit(gen, x, w, nb_classes, n_iter=2,
                                  init_centers=centers)
    else:
        _, y = gmm_mod.kmeans_fit(gen, x, w, nb_classes, n_iter=max_iter)
    params = gmm_mod.gmm_fit_from_labels(x, y, w, nb_classes, max_iter=1)
    model = ClassModel(params.weights, params.means, params.covs)
    return model, y.cpu().numpy()


def compute_edge_model(edges, proba, metric='lT'):
    """Edge weights from the per-vertex probabilities (host):
    ``exp(-dist / (2 std(dist)^2))`` with dist the paired L1 / L2 / max
    channel squared difference.

    >>> proba = np.array([[0.9, 0.1], [0.8, 0.2], [0.1, 0.9]])
    >>> w = compute_edge_model(np.array([[0, 1], [1, 2]]), proba, 'l1')
    >>> bool(w[0] > w[1])
    True
    """
    edges = np.asarray(edges, int)
    proba = np.asarray(proba, float)
    if np.max(edges) >= len(proba):
        raise ValueError('max vertex %i exceeds size of proba %r'
                         % (np.max(edges), proba.shape))
    v1, v2 = proba[edges[:, 0]], proba[edges[:, 1]]
    if metric == 'l1':
        dist = np.sum(np.abs(v1 - v2), axis=1)
    elif metric == 'l2':
        dist = np.sqrt(np.sum((v1 - v2) ** 2, axis=1))
    elif metric == 'lT':
        dist = np.max((v1 - v2) ** 2, axis=1)
    else:
        logging.error('not implemented for: %s', metric)
        return np.ones(len(edges))
    return np.exp(-dist / (2 * np.std(dist) ** 2))


def create_pairwise_matrix_specif(pos_weights, nb_classes=None):
    """Pairwise matrix with specific off-diagonal entries, 1 elsewhere.

    >>> create_pairwise_matrix_specif([((1, 2), 0.5), ((1, 0), 0.7)], 4)
    array([[0. , 0.7, 1. , 1. ],
           [0.7, 0. , 0.5, 1. ],
           [1. , 0.5, 0. , 1. ],
           [1. , 1. , 1. , 0. ]])
    """
    if nb_classes is None:
        nb_classes = int(max(max(i, j) for (i, j), _ in pos_weights)) + 1
    mat = np.ones((nb_classes, nb_classes)) - np.eye(nb_classes)
    for (i, j), w in pos_weights:
        mat[i, j] = w
        mat[j, i] = w
    return mat


def insert_gc_debug_images(debug_visual, segments, graph_labels, unary_cost,
                           edges, edge_weights, device='cuda'):
    """Stash the MRF's variables for visual debugging.

    The array entries come first: ``segments``, ``edges``, ``edge_weights``
    and ``imgs_unary_cost`` (one ``Greens`` image per class, numpy only).
    Then the superpixel centres (a tensor ``segments`` on its device, a
    numpy one on ``device``) and ``img_graph_edges``, the graph drawn
    through a matplotlib canvas, which raises ``ImportError`` where
    matplotlib is not installed."""
    if debug_visual is None:
        return
    from pyimsegm_tpu_torch.superpixels import superpixel_centers
    from pyimsegm_tpu_torch.utils.drawing import (
        draw_graphcut_unary_cost_segments,
        draw_graphcut_weighted_edges,
    )
    segments_np = host_array(segments)
    debug_visual['segments'] = segments_np
    debug_visual['edges'] = host_array(edges)
    debug_visual['edge_weights'] = host_array(edge_weights)
    debug_visual['imgs_unary_cost'] = draw_graphcut_unary_cost_segments(
        segments_np, host_array(unary_cost))
    centres = superpixel_centers(segments, device=device)
    debug_visual['img_graph_edges'] = draw_graphcut_weighted_edges(
        segments_np, centres, debug_visual['edges'],
        debug_visual['edge_weights'],
        img_bg=debug_visual.get('slic_mean', None))


def segment_graph_cut_general(slic, proba, image=None, features=None,
                              gc_regul=1.0, edge_type='model', edge_cost=1.0,
                              debug_visual=None, device='cuda'):
    """MRF stage with the reference's signature on any label map (the
    edge-list solve); a tensor ``slic`` runs on its device, a numpy one on
    ``device``.  Returns (K,) numpy labels per superpixel."""
    slic_t = as_tensor(slic, device)
    dev = slic_t.device
    k = int(slic_t.max()) + 1

    def f32(x):
        return None if x is None else as_tensor(x, dev).to(torch.float32)

    proba_t = f32(proba)
    out = _segment_graph_cut_core(
        slic_t, proba_t, k, image=f32(image), features=f32(features),
        gc_regul=gc_regul, edge_type=edge_type, edge_cost=edge_cost)
    if debug_visual is not None:
        unary = compute_unary_cost(proba_t).cpu().numpy()
        slic_np = slic_t.cpu().numpy()
        debug_visual['imgs_unary_cost'] = [unary[:, i][slic_np]
                                           for i in range(unary.shape[1])]
    return out.cpu().numpy()
