"""MRF regularisation of superpixel class probabilities (port of
``pyimsegm_tpu.ops.graphcut``).

Clipped ``|log p|`` unary costs, the Potts / matrix pairwise costs, the
edge list of any 2D or 3D label map with every edge type
(:func:`compute_edge_weights`), and three solvers of
``E(l) = sum_i U_i(l_i) + sum_e w_e P(l_a, l_b)``: the dense 25-neighbour
grid solve of 2D SLIC superpixels
(:func:`pyimsegm_tpu_torch.ops.grid.solve_mrf_grid`), the 125-neighbour
one of 3D SLIC supervoxels
(:func:`pyimsegm_tpu_torch.ops.slic3d.solve_mrf_grid3d`), and for any
other graph the edge-list :func:`solve_mrf`.  All three run damped mean
field, then ICM with best-energy tracking
(:func:`pyimsegm_tpu_torch.ops.mrf.mean_field_icm`); :func:`solve_mrf`
then runs stochastic expansion-move chains batched over a chain
dimension.  Its messages are ``index_add_`` sums over the edge
list, whose float atomics on a CUDA device add in a varying order, so its
result is held by energy, not by bits.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.ops.mrf import mean_field_icm
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
    """Edge list + weights of a 2D or 3D label map, every edge type of the
    reference.

    :param labels: (H, W) or (Z, H, W) integer tensor in [0, num_segments)
    :param edge_type: '' | 'spatial' | 'color' | 'features' |
        'model[_l1|_l2|_lT]'
    :param centers: optional (K, ndim) superpixel centres (reduced from the
        labels when not given)
    :param grid_cfg3d: the ``Slic3DConfig`` of SLIC supervoxels, whose edge
        list then comes from their grid (the same list)
    :returns: (edges (8K, 2) int32, weights (8K,), valid (8K,) bool)
    """
    from pyimsegm_tpu_torch.ops import graph as graph_ops
    from pyimsegm_tpu_torch.ops import segment_stats
    ndim = labels.ndim
    if ndim == 2:
        edges, valid = graph_ops.adjacency_edges_2d(labels, num_segments)
    else:
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
                                                   ndim=ndim)
        spatial = graph_ops.compute_spatial_dist(centers, edges, valid,
                                                 relative=True)
        weights = weights / torch.clamp_min(spatial, 1e-12)

    weights = torch.clamp(weights, 1.0 / MIN_MAX_EDGE_WEIGHT,
                          MIN_MAX_EDGE_WEIGHT)
    return edges, torch.where(valid, weights, 0.0), valid


def mrf_energy(labels, unary, edges, weights, pairwise):
    """E(l) = sum_i U_i(l_i) + sum_e w_e * P(l_a, l_b); ``labels`` may
    carry leading batch dimensions, (..., K) -> (...)."""
    lab = labels.to(torch.int64)
    nodes = torch.arange(lab.shape[-1], device=lab.device)
    u = torch.sum(unary[nodes, lab], dim=-1)
    e = edges.to(torch.int64)
    p = pairwise[lab[..., e[:, 0]], lab[..., e[:, 1]]]
    return u + torch.sum(weights * p, dim=-1)


def edge_adjacency(edges, weights, num_segments):
    """The (K, K) symmetric weight matrix of an edge list in CSR form: each
    edge in both directions, padding edges (weight 0) included."""
    e = edges.to(torch.int64)
    idx = torch.cat([e, e.flip(1)], dim=0).T
    val = torch.cat([weights, weights]).to(torch.float32)
    return torch.sparse_coo_tensor(
        idx, val, (num_segments, num_segments),
        check_invariants=False).coalesce().to_sparse_csr()


def _neighbor_expectation(q, adj, pairwise):
    """For every node i: sum_{j in N(i)} w_ij * (P @ q_j): the product with
    P on the nodes, then one sparse product with the symmetric weight
    matrix ``adj`` (:func:`edge_adjacency`); ``q`` is (K, C) or (B, K, C)."""
    qp = q @ pairwise.T
    if q.ndim == 2:
        return adj @ qp
    b, k, c = qp.shape
    agg = adj @ qp.transpose(0, 1).reshape(k, b * c)
    return agg.reshape(k, b, c).transpose(0, 1)


def _chain_orders(c, n_expand_rounds, n_chains):
    """(chains, rounds * c) label orders, from ``np.random.RandomState(0)``
    as the reference draws them."""
    order_rng = np.random.RandomState(0)
    return np.stack([
        np.concatenate([order_rng.permutation(c)
                        for _ in range(n_expand_rounds)])
        for _ in range(n_chains)]).astype(np.int64)


def solve_mrf(unary, edges, weights, pairwise, n_mf_iters=30, n_icm_iters=12,
              damping=0.5, n_expand_rounds=12, n_move_steps=8, n_chains=4,
              move_noise=0.6, adj=None):
    """Minimise the MRF of an edge list on the device of ``unary``, with no
    host synchronisation.

    Damped mean field, then synchronous ICM keeping the best-energy
    labelling, then ``n_chains`` stochastic expansion-move chains, batched
    over a chain dimension: each sweeps the labels alpha in its order of
    :func:`_chain_orders`, relaxes the keep-vs-alpha move with a damped
    binary mean field from ``0.5 + (u - 0.5) * move_noise`` (``u`` uniform,
    from a ``torch.Generator`` seeded 42), steps to the hardened move and
    tracks its best-energy labelling; the best chain wins over the ICM
    state only when lower.

    :param unary: (K, C) float costs
    :param edges: (E, 2) integer edge list
    :param weights: (E,) float, 0 on padding
    :param pairwise: (C, C) cost matrix
    :param adj: :func:`edge_adjacency` of ``edges`` and ``weights``, built
        once by a caller that solves the same graph again
    :returns: (K,) int32 labels
    """
    unary = unary.to(torch.float32)
    dev = unary.device
    k, c = unary.shape
    pairwise = torch.as_tensor(pairwise, dtype=torch.float32, device=dev)
    weights = weights.to(torch.float32)
    edges = edges.to(torch.int64)

    if adj is None:
        adj = edge_adjacency(edges, weights, k)

    def message(q):
        return _neighbor_expectation(q, adj, pairwise)

    def energy(labels):
        return mrf_energy(labels, unary, edges, weights, pairwise)

    best_labels, best_e = mean_field_icm(unary, message, energy, n_mf_iters,
                                         n_icm_iters, damping)
    if n_expand_rounds == 0 or n_chains == 0:
        return best_labels.to(torch.int32)

    orders = torch.as_tensor(_chain_orders(c, n_expand_rounds, n_chains),
                             device=dev)                  # (B, T)
    gen = torch.Generator(device=dev).manual_seed(42)
    rows = torch.arange(n_chains, device=dev)
    cur = best_labels.expand(n_chains, k)
    bl, be = cur, best_e.expand(n_chains)
    for t in range(n_expand_rounds * c):
        alpha = orders[:, t]                              # (B,)
        u_alpha = unary.T[alpha]                          # (B, K)
        noise = torch.rand((n_chains, k), generator=gen, device=dev)
        b = 0.5 + (noise - 0.5) * move_noise
        oh_cur = F.one_hot(cur, c).to(torch.float32)      # (B, K, C)
        oh_alpha = F.one_hot(alpha, c).to(torch.float32)[:, None, :]
        u_cur = unary[torch.arange(k, device=dev)[None, :], cur]
        for _ in range(n_move_steps):
            q = (1.0 - b[..., None]) * oh_cur + b[..., None] * oh_alpha
            msg = message(q)                              # (B, K, C)
            c_keep = u_cur + torch.gather(msg, 2, cur[..., None])[..., 0]
            c_alpha = u_alpha + msg[rows, :, alpha]
            b_new = torch.sigmoid(c_keep - c_alpha)
            b = damping * b_new + (1.0 - damping) * b
        cur = torch.where(b > 0.5, alpha[:, None], cur)
        e = mrf_energy(cur, unary, edges, weights, pairwise)
        improved = e < be
        bl = torch.where(improved[:, None], cur, bl)
        be = torch.where(improved, e, be)
    winner = torch.argmin(be)
    out = torch.where(be[winner] < best_e, bl[winner], best_labels)
    return out.to(torch.int32)


def segment_graph_cut_general(labels, proba, num_segments, image=None,
                              features=None, gc_regul=1.0, edge_type='model',
                              edge_cost=1.0, grid_ctx=None, centers=None,
                              grid_ctx3d=None):
    """MRF stage on the superpixel graph: the dense grid solve for SLIC
    labels given with their grid, the edge-list :func:`solve_mrf` for any
    other label map.

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
    pairwise = torch.as_tensor(compute_pairwise_cost(gc_regul, proba.shape[1]),
                               dtype=torch.float32, device=unary.device)
    if grid_ctx is None and grid_ctx3d is None:
        with stage_range('edges'):
            edges, weights, _valid = compute_edge_weights(
                labels, num_segments, image=image, features=features,
                proba=proba, edge_type=edge_type, centers=centers)
        with stage_range('mrf'):
            return solve_mrf(unary, edges, weights * edge_cost, pairwise)
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


def count_label_transitions_connected_segments(list_slics, list_labels,
                                               nb_labels, device='cuda'):
    """Class transitions along the superpixel adjacency over a dataset,
    (nb_labels, nb_labels) float64 counts (the diagonal halved); the edge
    lists are built on ``device`` (a tensor label map on its own)."""
    from pyimsegm_tpu_torch.ops import graph as graph_ops
    from pyimsegm_tpu_torch.utils.device import as_tensor
    trans = np.zeros((nb_labels, nb_labels))
    for slic, labels in zip(list_slics, list_labels):
        slic_t = as_tensor(slic, device)
        k = int(slic_t.max()) + 1
        edges, valid = graph_ops.adjacency_edges_2d(slic_t, k)
        edges = edges[valid].cpu().numpy()
        pairs = np.asarray(labels)[edges]
        np.add.at(trans, (pairs[:, 0], pairs[:, 1]), 1)
        np.add.at(trans, (pairs[:, 1], pairs[:, 0]), 1)
    trans[np.diag_indices_from(trans)] /= 2
    return trans


def compute_pairwise_cost_from_transitions(trans, min_prob=1e-9):
    """``log(1 / ratio)`` pairwise costs from transition counts (host,
    float64)."""
    trans = np.asarray(trans, np.float64)
    if trans.ndim == 1:
        trans = np.tile(trans, (len(trans), 1))
    ratio = trans / np.sum(trans, axis=0, keepdims=True)
    n = len(ratio)
    for i in range(1, n):
        for j in range(i):
            el = max(ratio[i, j], ratio[j, i])
            ratio[i, j] = el
            ratio[j, i] = el
    ratio = np.maximum(ratio, min_prob)
    return np.log(1.0 / ratio)
