"""Region growing with learned shape priors (RG2Sp) and the one-shot object
GraphCut (port of ``pyimsegm_tpu.region_growing``).

* **shape models**: ray-length distributions of annotated objects, fitted
  with the port's mean shift, k-means, spectral clustering or variational
  Bayesian mixture, and turned into per-angle survival tables;
  :func:`shape_model_from_numpy` carries a model fitted elsewhere;
* **prior evaluation**: one batched bilinear lookup for every object and
  every superpixel centre (:mod:`pyimsegm_tpu_torch.ops.shape_prior`);
* **greedy solver**: every candidate flip scored at once from two
  ``index_add_`` sums over the static edge list;
* **GraphCut solver**: each round a clamped MRF on the full superpixel
  graph (candidates keep their data + shape costs on the labels of their
  neighbourhood, every other node is held to its label), solved by the
  dense 25-neighbour grid solve for grid labels and by the edge-list
  ``solve_mrf`` for any other.

The split between host and device is the reference's: the centre, shift
and volume hysteresis and its ``eig`` run on the host in float64; the data
and shape LUTs (float64, cast to f32 at the solve), the candidate masks,
the prior lookups, the unary and the solves stay on the device, and a
round moves the (K,) labels each way.  Entry points run on the device of
a tensor label map, a numpy one on ``device`` (``'cuda'`` by default).
"""

import logging
import math

import numpy as np
import torch

from pyimsegm_tpu_torch.labeling import histogram_regions_labels_norm
from pyimsegm_tpu_torch.models import clustering
from pyimsegm_tpu_torch.models.gmm import (GMMParams, gmm_predict_proba,
                                           kmeans_fit)
from pyimsegm_tpu_torch.ops import graph as graph_ops
from pyimsegm_tpu_torch.ops import shape_prior as sp_ops
from pyimsegm_tpu_torch.ops.graphcut import (MAX_PAIRWISE_COST,
                                             edge_adjacency, solve_mrf)
from pyimsegm_tpu_torch.ops.ray import (compute_ray_features_segm_2d,
                                        interpolate_ray_dist,
                                        shift_ray_features)
from pyimsegm_tpu_torch.ops.shape_prior import (  # noqa: F401  (re-export)
    compute_cumulative_distrib, compute_shape_prior_table_cdf)
from pyimsegm_tpu_torch.utils.device import as_tensor, stage_range

#: replacement for infinite Graph-Cut terms
GC_REPLACE_INF = 1e5
#: minimal shape-prior probability
MIN_SHAPE_PROB = 0.01
#: maximal unary probability
MAX_UNARY_PROB = 1 - 0.01
#: hysteresis thresholds for iterative region growing
RG2SP_THRESHOLDS = {
    'centre': 30,
    'shift': 15,
    'volume': 0.1,
    'centre_init': 50,
}


# ------------------------------------------------------------------ graph ---

def _graph_setup(slic, device='cuda'):
    """Static superpixel graph of a label map, on ``device`` (a tensor on
    its own): (K, edges (8K, 2), valid (8K,), centres (K, 2) f32, pixel
    counts (K,) float64), all numpy."""
    slic_t = as_tensor(slic, device)
    k = int(slic_t.max()) + 1
    edges, valid = graph_ops.adjacency_edges_2d(slic_t, k)
    centers = graph_ops.superpixel_centers(slic_t, k)
    weights = np.bincount(np.asarray(slic_t.cpu()).ravel(),
                          minlength=k).astype(float)
    return (k, edges.cpu().numpy(), valid.cpu().numpy(),
            centers.cpu().numpy(), weights)


def get_neighboring_segments(edges):
    """Edge list -> per-node neighbour lists."""
    edges = np.asarray(edges)
    n = int(edges.max()) + 1 if edges.size else 0
    neigh = [[] for _ in range(n)]
    for a, b in edges:
        if a == b:
            continue
        neigh[a].append(int(b))
        neigh[b].append(int(a))
    return neigh


def _neighbor_class_mask(edges, valid, labels, n_classes):
    """(K, C) bool: class c occurs among the conn4 neighbours of node k.
    Tensors stay on their device; numpy in, numpy out."""
    if not isinstance(labels, torch.Tensor):
        return _neighbor_class_mask(
            torch.as_tensor(np.asarray(edges)), torch.as_tensor(
                np.asarray(valid)), torch.as_tensor(np.asarray(labels)),
            n_classes).numpy()
    e = edges[valid].to(torch.int64)
    lab = labels.to(torch.int64)
    mask = torch.zeros(len(lab) * n_classes, dtype=torch.bool,
                       device=lab.device)
    true = torch.ones((), dtype=torch.bool, device=lab.device)
    mask.index_put_((e[:, 0] * n_classes + lab[e[:, 1]],), true)
    mask.index_put_((e[:, 1] * n_classes + lab[e[:, 0]],), true)
    return mask.reshape(len(lab), n_classes)


def get_neighboring_candidates(slic_neighbours, labels, object_idx,
                               use_other_obj=True):
    """Boundary-band candidates of one object.

    >>> neighbours = [[1], [0, 2, 3], [1, 3], [1, 2]]
    >>> labels = np.array([0, 0, 1, 1])
    >>> get_neighboring_candidates(neighbours, labels, 1)
    [1]
    """
    labels = np.asarray(labels)
    near = set()
    for idx in np.nonzero(labels == object_idx)[0]:
        near.update(slic_neighbours[idx])
    if use_other_obj:
        return sorted(lb for lb in near if labels[lb] != object_idx)
    return sorted(lb for lb in near if labels[lb] == 0)


def _candidate_masks(edges, valid, labels, nb_objects, allow_obj_swap,
                     neigh=None):
    """Candidates of every object at once: (K, nb_objects+1) bool, [:, o]
    marks nodes that neighbour object ``o`` and may flip to it (column 0
    unused).  ``neigh`` is the node's :func:`_neighbor_class_mask` when
    the caller has it."""
    if not isinstance(labels, torch.Tensor):
        return _candidate_masks(
            torch.as_tensor(np.asarray(edges)), torch.as_tensor(
                np.asarray(valid)), torch.as_tensor(np.asarray(labels)),
            nb_objects, allow_obj_swap).numpy()
    if neigh is None:
        neigh = _neighbor_class_mask(edges, valid, labels, nb_objects + 1)
    cls = torch.arange(nb_objects + 1, device=labels.device)
    lab = labels.to(torch.int64)[:, None]
    cand = neigh & ((lab != cls) if allow_obj_swap else (lab == 0))
    return cand & (cls > 0)


# ------------------------------------------------------- energy / penalty ---

def compute_pairwise_penalty(edges, labels, prob_bg_fg=0.05, prob_fg1_fg2=0.01):
    """Per-edge label-transition penalty.

    >>> edges = np.array([[0, 1], [1, 2], [0, 3], [2, 3], [2, 4]])
    >>> labels = np.array([0, 0, 1, 2, 1])
    >>> np.round(compute_pairwise_penalty(edges, labels, 0.05, 0.01), 4)
    array([0.    , 2.9957, 2.9957, 4.6052, 0.    ])
    """
    la = labels[edges[:, 0]]
    lb = labels[edges[:, 1]]
    is_diff = la != lb
    is_bg = is_diff & ((la == 0) | (lb == 0))
    costs = -np.log(prob_fg1_fg2) * is_diff.astype(float)
    costs[is_bg] = -np.log(prob_bg_fg)
    return costs


def _penalty_matrix(nb_classes, prob_label_trans):
    """(C, C) transition penalty: 0 diag, -log p_bg_fg vs bg, -log p_fg1_fg2
    among objects."""
    pen = np.full((nb_classes, nb_classes), -np.log(prob_label_trans[1]))
    pen[0, :] = pen[:, 0] = -np.log(prob_label_trans[0])
    np.fill_diagonal(pen, 0.0)
    return pen


def compute_rg_crit(labels, lut_data_cost, lut_shape_cost, slic_weights, edges,
                    coef_data, coef_shape, coef_pairwise, prob_label_trans):
    """RG2Sp criterion  sum_k w_k (cd*D + cs*S) + cp * sum_e pen, in
    float64; numpy arrays give a float, tensors a 0-dim tensor on their
    device."""
    if isinstance(labels, torch.Tensor):
        lab = labels.to(torch.int64)
        rng = torch.arange(len(lab), device=lab.device)
        crit = torch.sum(slic_weights * (
            coef_data * lut_data_cost[rng, lab]
            + coef_shape * lut_shape_cost[rng, lab]))
        if coef_pairwise > 0:
            pen = torch.as_tensor(_penalty_matrix(
                lut_data_cost.shape[1], prob_label_trans), device=lab.device)
            e = edges.to(torch.int64)
            pw = pen[lab[e[:, 0]], lab[e[:, 1]]]
            pw = torch.where(torch.isinf(pw), GC_REPLACE_INF, pw)
            crit = crit + coef_pairwise * torch.sum(pw)
        return crit
    rng = np.arange(len(labels))
    crit = np.sum(slic_weights * (coef_data * lut_data_cost[rng, labels]
                                  + coef_shape * lut_shape_cost[rng, labels]))
    if coef_pairwise > 0:
        pw = compute_pairwise_penalty(edges, labels, prob_label_trans[0],
                                      prob_label_trans[1])
        pw[np.isinf(pw)] = GC_REPLACE_INF
        crit += coef_pairwise * np.sum(pw)
    return crit


def compute_segm_prob_fg(slic, segm, labels_prob):
    """Superpixel foreground probability from a semantic segmentation.

    >>> slic = np.array([[0, 0, 0, 0, 1, 1, 1, 1], [2, 2, 2, 2, 3, 3, 3, 3]])
    >>> segm = np.array([0, 1, 1, 0])[slic]
    >>> compute_segm_prob_fg(slic, segm, [0.3, 0.8])
    array([0.3, 0.8, 0.8, 0.3])
    """
    label_hist = histogram_regions_labels_norm(slic, segm)
    slic_labels = np.argmax(label_hist, axis=1)
    return np.asarray(labels_prob)[slic_labels]


def compute_data_costs_points(slic, slic_prob_fg, centres, labels):
    """Data-term LUT (float64); the centres' superpixels are
    hard-assigned."""
    slic_prob_fg = np.asarray(slic_prob_fg, float)
    proba = np.empty((len(labels), len(centres) + 1))
    proba[:, 0] = 1.0 - slic_prob_fg
    for i, centre in enumerate(centres):
        proba[:, i + 1] = slic_prob_fg
        vertex = slic[int(centre[0]), int(centre[1])]
        labels[vertex] = i + 1
    lut = -np.log(proba + 1e-9)
    lut[np.isinf(lut)] = GC_REPLACE_INF
    return lut, labels


def enforce_center_labels(slic, labels, centres):
    """Pin each centre's superpixel to its object."""
    for i, c in enumerate(centres):
        labels[slic[int(c[0]), int(c[1])]] = i + 1
    return labels


# ----------------------------------------------------------- shape models ---

def compute_segm_object_shape(img_object, ray_step=5, interp_order=3,
                              smooth_coef=0, shift_method='phase',
                              device='cuda'):
    """Centre-of-mass ray signature of one binary object: (rays list,
    shift); the rays are cast on ``device``."""
    img_object = np.asarray(img_object).astype(bool)
    total = img_object.sum()
    if total == 0:
        n = int(360 / ray_step)
        return [0.0] * n, 0.0
    ys, xs = np.nonzero(img_object)
    centre = [int(round(ys.mean())), int(round(xs.mean()))]
    ray = compute_ray_features_segm_2d(img_object, centre, ray_step, 0,
                                       edge='down', device=device)
    if interp_order is not None and -1 in ray:
        ray = interpolate_ray_dist(ray, interp_order)
    if smooth_coef > 0:
        from scipy.ndimage import gaussian_filter1d
        ray = gaussian_filter1d(ray, smooth_coef)
    ray, shift = shift_ray_features(ray, shift_method)
    return np.asarray(ray).tolist(), shift


def _connected_components(binary):
    """conn4 components of a binary mask (host, ``scipy.ndimage``)."""
    from scipy import ndimage
    lab, _ = ndimage.label(binary)
    return lab


def compute_object_shapes(list_img_objects, ray_step=5, interp_order=3,
                          smooth_coef=0, shift_method='phase', device='cuda'):
    """Ray signatures of every object over a dataset; a map of at most two
    labels is split into its conn4 components."""
    list_rays, list_shifts = [], []
    for img_objects in list_img_objects:
        img_objects = np.asarray(img_objects)
        uq = np.unique(img_objects)
        if len(uq) <= 2:
            img_objects = _connected_components(img_objects > 0)
            uq = np.unique(img_objects)
        for lb in uq[uq > 0]:
            rays, shift = compute_segm_object_shape(
                img_objects == lb, ray_step, interp_order, smooth_coef,
                shift_method, device=device)
            list_rays.append(rays)
            list_shifts.append(shift)
    return list_rays, list_shifts


class GMMShapeModel:
    """Mixture over ray vectors with a numpy ``predict_proba``; its
    :class:`GMMParams` stay on their device."""

    def __init__(self, params: GMMParams):
        self.params = params
        self.weights_ = params.weights.cpu().numpy()
        self.means_ = params.means.cpu().numpy()
        self.covariances_ = params.covs.cpu().numpy()

    def predict_proba(self, x):
        x = torch.as_tensor(np.atleast_2d(np.asarray(x, np.float32)),
                            device=self.params.means.device)
        return gmm_predict_proba(self.params, x).cpu().numpy()


class KMeansShapeModel:
    """Hard-assignment mixture stand-in for the k-means shape sets."""

    def __init__(self, centers, labels, device='cuda'):
        self.cluster_centers_ = np.asarray(centers)
        self.labels_ = np.asarray(labels)
        self.device = device

    def predict_proba(self, x):
        d2 = clustering.pairwise_dist2(
            np.atleast_2d(x), self.cluster_centers_,
            device=self.device).cpu().numpy()
        proba = np.zeros_like(d2)
        proba[np.arange(len(d2)), np.argmin(d2, axis=1)] = 1.0
        return proba


def _generator(device):
    """The fits' random source: a ``torch.Generator`` on ``device`` seeded
    with 0."""
    return torch.Generator(device=torch.device(device)).manual_seed(0)


def _fit_rays(list_rays, device):
    rays = np.asarray(list_rays, float)
    x = as_tensor(rays.astype(np.float32), device)
    return rays, x, torch.ones(len(rays), dtype=torch.float32,
                               device=x.device)


def transform_rays_model_cdf_mixture(list_rays, coef_components=1,
                                     device='cuda'):
    """Variational Bayesian mixture shape model -> (model, survival table
    as a list); the component count from the mean-shift modes."""
    from pyimsegm_tpu_torch.models.bgm import bgm_fit
    rays, x, w = _fit_rays(list_rays, device)
    _, ms_labels = clustering.mean_shift(rays, device=device)
    nb_components = max(1, min(len(np.unique(ms_labels)) * coef_components,
                               len(rays)))
    params = bgm_fit(_generator(x.device), x, w, int(nb_components),
                     n_init=4, max_iter=99)
    model = GMMShapeModel(params)
    stds = np.sqrt(np.abs(np.diagonal(model.covariances_, axis1=1, axis2=2)))
    max_dist = np.max(model.means_ + stds)
    cdist = compute_cumulative_distrib(model.means_, stds, model.weights_,
                                       max_dist, device=x.device)
    return model, cdist.tolist()


def _smooth1d(x, sigma=1.0):
    from scipy.ndimage import gaussian_filter1d
    return gaussian_filter1d(np.asarray(x, float), sigma)


def transform_rays_model_sets_mean_cdf_mixture(list_rays, nb_components=5,
                                               slic_size=15, device='cuda'):
    """Diagonal variational Bayesian mixture -> (model, per-component
    (mean, survival table) sets)."""
    from pyimsegm_tpu_torch.models.bgm import bgm_fit
    rays, x, w = _fit_rays(list_rays, device)
    nb_components = max(1, min(int(nb_components), len(rays)))
    params = bgm_fit(_generator(x.device), x, w, nb_components, n_init=4,
                     max_iter=99, diag=True)
    model = GMMShapeModel(params)
    list_mean_cdf = []
    for mean, covar in zip(model.means_, model.covariances_):
        var = np.diagonal(covar) if covar.ndim == 2 else covar
        std = np.sqrt(var + 1) * 2 + slic_size
        mean = _smooth1d(mean)
        std = _smooth1d(std)
        max_dist = np.max(mean + 2 * std)
        cdist = compute_cumulative_distrib(mean[None], std[None],
                                           np.ones(1), max_dist,
                                           device=x.device)
        list_mean_cdf.append((mean.tolist(), cdist))
    return model, list_mean_cdf


def transform_rays_model_sets_mean_cdf_kmeans(list_rays, nb_components=5,
                                              device='cuda'):
    """K-means cluster shapes -> (model, per-cluster (mean, survival
    table) sets)."""
    rays, x, w = _fit_rays(list_rays, device)
    nb_components = max(1, min(nb_components, len(rays)))
    centers, labels = kmeans_fit(_generator(x.device), x, w, nb_components)
    model = KMeansShapeModel(centers.cpu().numpy(), labels.cpu().numpy(),
                             device=x.device)
    list_mean_cdf = []
    for lb, mean in enumerate(model.cluster_centers_):
        members = rays[model.labels_ == lb]
        std = members.std(axis=0) if len(members) else np.zeros(rays.shape[1])
        mean = _smooth1d(mean)
        std = (_smooth1d(std) + 1) * 5.0
        max_dist = np.max(mean + 2 * std)
        cdist = compute_cumulative_distrib(mean[None], std[None],
                                           np.ones(1), max_dist,
                                           device=x.device)
        list_mean_cdf.append((mean.tolist(), cdist))
    return model, list_mean_cdf


def transform_rays_model_cdf_spectral(list_rays, nb_components=5,
                                      device='cuda'):
    """Spectral-clustering mixture -> (model, survival table)."""
    rays = np.asarray(list_rays, float)
    nb_components = max(1, min(nb_components, len(rays)))
    labels = clustering.spectral_clustering(rays, nb_components,
                                            device=device)
    uq = np.unique(labels)
    means = np.stack([_smooth1d(rays[labels == lb].mean(axis=0)) for lb in uq])
    stds = np.stack([rays[labels == lb].std(axis=0) for lb in uq]) + 1
    weights = np.bincount(labels)[uq] / float(len(labels))
    max_dist = np.max(means + stds)
    cdist = compute_cumulative_distrib(means, stds, weights, max_dist,
                                       device=device)
    model = KMeansShapeModel(means, labels, device=device)
    return model, cdist.tolist()


def transform_rays_model_cdf_kmeans(list_rays, nb_components=None,
                                    device='cuda'):
    """K-means mixture -> (model, survival table); the component count
    from the mean-shift modes when not given."""
    rays, x, w = _fit_rays(list_rays, device)
    if not nb_components:
        _, ms_labels = clustering.mean_shift(rays, device=device)
        nb_components = len(np.unique(ms_labels))
    nb_components = max(1, min(nb_components, len(rays)))
    centers, labels = kmeans_fit(_generator(x.device), x, w, nb_components)
    centers, labels = centers.cpu().numpy(), labels.cpu().numpy()
    stds = np.stack([
        rays[labels == lb].std(axis=0) if np.any(labels == lb)
        else np.zeros(rays.shape[1]) for lb in range(nb_components)]) + 1
    weights = np.bincount(labels, minlength=nb_components) / float(len(labels))
    max_dist = np.max(centers + stds)
    cdist = compute_cumulative_distrib(centers, stds, weights, max_dist,
                                       device=x.device)
    return KMeansShapeModel(centers, labels, device=x.device), cdist.tolist()


def transform_rays_model_cdf_histograms(list_rays, nb_bins=10):
    """Per-angle cumulative histograms (host)."""
    rays = np.asarray(list_rays)
    max_dist = int(np.max(rays))
    list_chist = []
    for i in range(rays.shape[1]):
        cum = np.zeros(max_dist + 1)
        hist, bin_edges = np.histogram(rays[:, i], nb_bins)
        hist = hist.astype(float) / np.sum(hist)
        bins = ((bin_edges[1:] + bin_edges[:-1]) / 2).astype(int)
        cum[:bins[0]] = 1
        for j, edge in enumerate(bins):
            cum[edge:] = cum[edge - 1] - hist[j]
        list_chist.append(cum.tolist())
    return list_chist


def shape_model_to_numpy(model, tables):
    """The arrays of a fitted shape model (this package's or any with the
    same attributes): ``weights``, ``means``, ``covs`` of a mixture or
    ``centers``, ``labels`` of a k-means model, and ``cdf`` (A, D) for one
    table or ``set_means`` (J, A) with ``set_cdf_<j>`` for a set."""
    if hasattr(model, 'weights_'):
        out = {'weights': np.asarray(model.weights_, np.float32),
               'means': np.asarray(model.means_, np.float32),
               'covs': np.asarray(model.covariances_)}
    else:
        out = {'centers': np.asarray(model.cluster_centers_),
               'labels': np.asarray(model.labels_)}
    if tables and isinstance(tables[0], tuple):
        out['set_means'] = np.asarray([m for m, _ in tables], np.float64)
        for j, (_, cdf) in enumerate(tables):
            out['set_cdf_%d' % j] = np.asarray(cdf, np.float32)
    else:
        out['cdf'] = np.asarray(tables, np.float32)
    return out


def shape_model_from_numpy(arrays, device='cuda'):
    """A shape model of this package from the arrays of
    :func:`shape_model_to_numpy` (e.g. of a model fitted by the JAX
    package): (model, table list) or (model, list of (mean, table))."""
    if 'weights' in arrays:
        dev = as_tensor(np.zeros(1), device).device
        covs = np.array(arrays['covs'])
        model = GMMShapeModel(GMMParams(
            torch.as_tensor(np.array(arrays['weights'], np.float32),
                            device=dev),
            torch.as_tensor(np.array(arrays['means'], np.float32),
                            device=dev),
            torch.as_tensor(covs if covs.dtype == np.float64
                            else covs.astype(np.float32), device=dev)))
    else:
        model = KMeansShapeModel(arrays['centers'], arrays['labels'],
                                 device=device)
    if 'set_means' in arrays:
        return model, [(m.tolist(), np.asarray(arrays['set_cdf_%d' % j]))
                       for j, m in enumerate(arrays['set_means'])]
    return model, np.asarray(arrays['cdf']).tolist()


# ------------------------------------------------------ shape-cost update ---

def compute_centre_moment_points(points):
    """Centre + principal-axis orientation (whole degrees) of a point cloud
    (host, float64 ``eig``)."""
    points = np.asarray(points, float)
    centre = points.mean(axis=0)
    diff = points - centre
    if len(points) > 1:
        cov = np.cov(diff.T)
        evals, evecs = np.linalg.eig(cov)
        evec1 = evecs[:, np.argmax(evals)]
        theta = np.arctan2(evec1[0], evec1[1])
    else:
        theta = 0
    theta = (360 + round(np.rad2deg(theta))) % 360
    return centre, float(theta)


def _prior_costs(points, tables, centres, shifts, selected_mask=None):
    """(O, N) f32 costs ``-log(prior + MIN_SHAPE_PROB)`` of every object at
    once on the device of ``points`` (no host synchronisation).

    :param points: (N, 2) tensor
    :param tables: (A, D) shared table or (O, A, D), an array or an f32
        tensor on the points' device
    :param centres: (O, 2); ``shifts``: (O,)
    :param selected_mask: optional (N,) bool tensor; other points take
        prior 0
    """
    o = len(centres)
    dev = points.device
    if not isinstance(tables, torch.Tensor):
        tables = torch.as_tensor(np.asarray(tables, np.float32), device=dev)
    if tables.ndim == 2:
        tables = tables.expand((o,) + tuple(tables.shape))
    proba = sp_ops.shape_prior_points(
        points, tables,
        torch.as_tensor(np.asarray(centres, np.float32), device=dev),
        torch.as_tensor(np.asarray(shifts, np.float32), device=dev))
    if selected_mask is not None:
        proba = torch.where(selected_mask[None, :], proba, 0.0)
    cost = -torch.log(proba + MIN_SHAPE_PROB)
    return torch.where(torch.isinf(cost), GC_REPLACE_INF, cost)


def _eval_prior_costs(points, cdf, centre, shift, selected_mask=None,
                      device='cuda'):
    """-log(prior + eps) of one object for all points (numpy)."""
    pts = as_tensor(np.asarray(points, np.float32), device)
    sel = None if selected_mask is None else torch.as_tensor(
        np.asarray(selected_mask, bool), device=pts.device)
    return _prior_costs(pts, np.asarray(cdf, np.float32)[None], [centre],
                        [shift], sel)[0].cpu().numpy()


def _eval_prior_costs_all(points, tables, centres, shifts,
                          selected_mask=None, device='cuda'):
    """-log(prior + eps) of all objects at once (numpy (O, N));
    ``tables`` is (O, A, D)."""
    pts = as_tensor(np.asarray(points, np.float32), device)
    sel = None if selected_mask is None else torch.as_tensor(
        np.asarray(selected_mask, bool), device=pts.device)
    return _prior_costs(pts, tables, centres, shifts, sel).cpu().numpy()


def _hysteresis_update(i, points, labels, init_centres, centres, shifts,
                       volumes, swap_shift, thresholds, track_volume):
    """Centre / shift / volume hysteresis of one object (host).  Returns
    (changed, shift)."""
    members = points[labels == i + 1]
    if len(members) == 0:
        return False, shifts[i]
    centre_new, shift = compute_centre_moment_points(members)
    centre_new = np.round(centre_new).astype(int)
    if swap_shift:
        shift = (shift + 90) % 360
        shifts[i] = shift

    volume_diff = 0.0
    if track_volume:
        volume = np.sum(labels == (i + 1))
        volume_diff = 0 if volumes[i] == 0 else \
            np.abs(volume - volumes[i]) / float(volumes[i])

    cdist_init_2 = np.sum((centre_new - np.asarray(init_centres[i])) ** 2)
    if cdist_init_2 > thresholds['centre_init'] ** 2:
        diff = centre_new - np.asarray(init_centres[i])
        thr = thresholds['centre_init'] / np.sqrt(cdist_init_2)
        centre_new = init_centres[i] + thr * diff

    cdist_act_2 = np.sum((np.asarray(centre_new) - np.asarray(centres[i])) ** 2)
    in_centre = cdist_act_2 <= thresholds['centre'] ** 2
    in_shift = np.abs(shift - shifts[i]) <= thresholds['shift']
    in_volume = (not track_volume) or volume_diff <= thresholds['volume']
    if in_centre and in_shift and in_volume and not swap_shift:
        return False, shift
    if cdist_act_2 > thresholds['centre'] ** 2:
        centres[i] = np.asarray(centre_new).tolist()
    if np.abs(shift - shifts[i]) > thresholds['shift']:
        shifts[i] = shift
    if track_volume and volume_diff > thresholds['volume']:
        volumes[i] = np.sum(labels == (i + 1))
    return True, shift


def _selected_mask(selected_idx, n, device):
    if selected_idx is None:
        return None
    sel = torch.zeros(n, dtype=torch.bool, device=device)
    sel[torch.as_tensor(np.asarray(selected_idx, np.int64), device=device)] \
        = True
    return sel


def _write_columns(lut, costs, changed_mask):
    """Columns i + 1 of the float64 LUT tensor from the f32 costs of the
    changed objects (``costs`` None when none changed); infinite entries
    become ``GC_REPLACE_INF``."""
    idx = [i for i, ch in enumerate(changed_mask) if ch]
    if idx:
        rows = torch.as_tensor(idx, device=lut.device)
        lut[:, rows + 1] = costs[rows].T.to(lut.dtype)
    return torch.where(torch.isinf(lut), GC_REPLACE_INF, lut)


def _update_table_cdf(lut, points, points_t, labels, init_centres, centres,
                      shifts, volumes, shape_chist, selected_idx, swap_shift,
                      thresholds):
    """Shape-cost update of the single-table CDF model on the LUT tensor
    ``lut``: the hysteresis on the host, then one lookup for all objects
    and the changed objects' columns written, on the device."""
    centres = [list(c) for c in centres]
    shifts = np.asarray(shifts, float)
    changed_mask = []
    for i in range(len(centres)):
        changed, _ = _hysteresis_update(
            i, points, labels, init_centres, centres, shifts, volumes,
            swap_shift, thresholds, track_volume=False)
        changed_mask.append(changed)
    costs = None
    if any(changed_mask):
        _, cdf = shape_chist
        costs = _prior_costs(points_t, cdf, centres, shifts, _selected_mask(
            selected_idx, len(points), lut.device))
    return (_write_columns(lut, costs, changed_mask), np.array(centres),
            np.array(shifts, float), volumes)


def _update_close_mean_cdf(lut, slic, points, points_t, labels, init_centres,
                           centres, shifts, volumes, shape_model_cdfs,
                           selected_idx, swap_shift, thresholds):
    """Shape-cost update blending the component tables by the mixture
    posterior of each object's current ray signature."""
    centres = [list(c) for c in centres]
    shifts = np.asarray(shifts, float)
    segm_obj = labels[np.asarray(slic)]
    model, list_mean_cdf = shape_model_cdfs
    list_cdfs = [np.asarray(cdf) for _, cdf in list_mean_cdf]
    angle_step = 360 / len(list_cdfs[0])
    max_shape = tuple(np.max([c.shape for c in list_cdfs], axis=0))
    changed_mask, tables = [], []
    for i in range(len(centres)):
        rays, _ = compute_segm_object_shape(segm_obj == i + 1, angle_step,
                                            smooth_coef=0,
                                            device=lut.device)
        changed, _ = _hysteresis_update(
            i, points, labels, init_centres, centres, shifts, volumes,
            swap_shift, thresholds, track_volume=True)
        changed_mask.append(changed)
        if not changed:
            tables.append(np.zeros(max_shape))
            continue
        weights = model.predict_proba([rays]).ravel()
        cdist = np.zeros(max_shape)
        for j, cdf in enumerate(list_cdfs):
            cdist[:, :cdf.shape[1]] += weights[j] * cdf
        tables.append(cdist)
    costs = None
    if any(changed_mask):
        costs = _prior_costs(points_t, np.stack(tables), centres, shifts,
                             _selected_mask(selected_idx, len(points),
                                            lut.device))
    return (_write_columns(lut, costs, changed_mask), np.array(centres),
            np.array(shifts, float), volumes)


def _update_shape_costs(lut, slic, points, points_t, labels, init_centres,
                        centres, shifts, volumes, shape_model, shape_type,
                        selected_idx=None, swap_shift=False,
                        dict_thresholds=None):
    """:func:`update_shape_costs_points` on a LUT tensor, with the points
    both on the host (numpy) and on the LUT's device."""
    thresholds = RG2SP_THRESHOLDS if dict_thresholds is None \
        else dict_thresholds
    labels = np.asarray(labels)
    if len(points) != len(labels):
        raise ValueError('number of points (%i) and labels (%i) should match'
                         % (len(points), len(labels)))
    if shape_type == 'cdf':
        return _update_table_cdf(lut, points, points_t, labels, init_centres,
                                 centres, shifts, volumes, shape_model,
                                 selected_idx, swap_shift, thresholds)
    if shape_type == 'set_cdfs':
        return _update_close_mean_cdf(
            lut, slic, points, points_t, labels, init_centres, centres,
            shifts, volumes, shape_model, selected_idx, swap_shift,
            thresholds)
    raise NameError('Not supported type of shape model "%s"' % shape_type)


def _numpy_update(shape_type, lut_shape_cost, slic, points, labels,
                  init_centres, centres, shifts, volumes, shape_model,
                  selected_idx, swap_shift, dict_thresholds, device):
    points = np.asarray(points)
    lut = as_tensor(np.asarray(lut_shape_cost, float), device)
    points_t = torch.as_tensor(points.astype(np.float32), device=lut.device)
    lut, centres, shifts, volumes = _update_shape_costs(
        lut, slic, points, points_t, labels, init_centres, centres, shifts,
        volumes, shape_model, shape_type, selected_idx, swap_shift,
        dict_thresholds)
    lut_shape_cost[...] = lut.cpu().numpy()
    return lut_shape_cost, centres, shifts, volumes


def compute_update_shape_costs_points_table_cdf(
        lut_shape_cost, points, labels, init_centres, centres, shifts,
        volumes, shape_chist, selected_idx=None, swap_shift=False,
        dict_thresholds=None, device='cuda'):
    """Shape-cost update for the single-table CDF model (numpy LUT, updated
    in place and returned); the prior lookups run on ``device``."""
    return _numpy_update('cdf', lut_shape_cost, None, points, labels,
                         init_centres, centres, shifts, volumes, shape_chist,
                         selected_idx, swap_shift, dict_thresholds, device)


def compute_update_shape_costs_points_close_mean_cdf(
        lut_shape_cost, slic, points, labels, init_centres, centres, shifts,
        volumes, shape_model_cdfs, selected_idx=None, swap_shift=False,
        dict_thresholds=None, device='cuda'):
    """Shape-cost update blending component tables by the mixture posterior
    of the object's current ray signature (numpy LUT)."""
    return _numpy_update('set_cdfs', lut_shape_cost, slic, points, labels,
                         init_centres, centres, shifts, volumes,
                         shape_model_cdfs, selected_idx, swap_shift,
                         dict_thresholds, device)


def update_shape_costs_points(lut_shape_cost, slic, points, labels,
                              init_centres, centres, shifts, volumes,
                              shape_model, shape_type, selected_idx=None,
                              swap_shift=False, dict_thresholds=None,
                              device='cuda'):
    """Dispatch by shape-model type ('cdf' or 'set_cdfs'; numpy LUT)."""
    if shape_type not in ('cdf', 'set_cdfs'):
        raise NameError('Not supported type of shape model "%s"' % shape_type)
    return _numpy_update(shape_type, lut_shape_cost, slic, points, labels,
                         init_centres, centres, shifts, volumes, shape_model,
                         selected_idx, swap_shift, dict_thresholds, device)


# ------------------------------------------------------------ RG2Sp setup ---

class _RGState:
    """What both RG2Sp solvers set up once: the graph on the host and on
    the device, the data LUT and the first shape LUT (float64 tensors),
    and the hysteresis state."""

    def __init__(self, slic, slic_prob_fg, centres, shape_model, shape_type,
                 thresholds, device, shape_bg_eps):
        self.slic = np.asarray(slic.cpu() if isinstance(slic, torch.Tensor)
                               else slic)
        if len(slic_prob_fg) < np.max(self.slic):
            raise ValueError('dims of probs %s and slic %s not match'
                             % (len(slic_prob_fg), np.max(self.slic)))
        slic_t = as_tensor(slic, device)
        self.dev = slic_t.device
        (self.k, self.edges, self.evalid, self.centers,
         self.slic_weights) = _graph_setup(slic_t)
        self.slic_points = np.round(self.centers).astype(int)
        self.init_centres = np.round(np.asarray(centres)).astype(int)
        self.nb_obj = len(self.init_centres)
        dev = self.dev
        if shape_type == 'cdf':
            # the one table, on the device once
            shape_model = (shape_model[0], torch.as_tensor(
                np.asarray(shape_model[1], np.float32), device=dev))
        self.shape_model, self.shape_type = shape_model, shape_type
        self.thresholds = thresholds

        self.edges_t = torch.as_tensor(self.edges.astype(np.int64), device=dev)
        self.evalid_t = torch.as_tensor(self.evalid, device=dev)
        self.edges_valid_t = self.edges_t[self.evalid_t]
        self.points_t = torch.as_tensor(self.slic_points.astype(np.float32),
                                        device=dev)
        self.weights_t = torch.as_tensor(self.slic_weights, device=dev)

        labels = np.zeros(self.k, dtype=int)
        lut_data, labels = compute_data_costs_points(
            self.slic, slic_prob_fg, self.init_centres, labels)
        self.labels = labels
        self.lut_data_np = lut_data
        self.lut_data = torch.as_tensor(lut_data, device=dev)
        lut_shape = np.empty((self.k, self.nb_obj + 1))
        lut_shape[:, 0] = -np.log(1 - np.asarray(slic_prob_fg, float)
                                  + shape_bg_eps)
        lut_shape[:, 1:] = 0.0
        self.lut_shape = torch.as_tensor(lut_shape, device=dev)
        self.centres_act = np.full(self.init_centres.shape, np.inf)
        self.shifts = np.zeros(self.nb_obj)
        self.volumes = [1] * self.nb_obj
        self.update_shape(self.labels, False)

    def update_shape(self, labels, swap_shift):
        with stage_range('shape_update'):
            (self.lut_shape, self.centres_act, self.shifts,
             self.volumes) = _update_shape_costs(
                self.lut_shape, self.slic, self.slic_points, self.points_t,
                labels, self.init_centres, self.centres_act, self.shifts,
                self.volumes, self.shape_model, self.shape_type, None,
                swap_shift, self.thresholds)

    def start_history(self, debug_history):
        if debug_history is not None:
            debug_history.update({
                'criteria': [], 'labels': [], 'centres': [], 'shifts': [],
                'lut_data_cost': self.lut_data_np.copy(),
                'lut_shape_cost': []})

    def record(self, debug_history, labels, labels_t, coefs):
        """Append a round to the history; the criterion and the shape LUT
        stay on the device until :meth:`close_history`."""
        if debug_history is None:
            return
        debug_history['labels'].append(labels.copy())
        debug_history['criteria'].append(compute_rg_crit(
            labels_t, self.lut_data, self.lut_shape, self.weights_t,
            self.edges_valid_t, *coefs))
        debug_history['centres'].append(self.centres_act.copy())
        debug_history['shifts'].append(self.shifts.tolist())
        debug_history['lut_shape_cost'].append(self.lut_shape.clone())

    @staticmethod
    def close_history(debug_history):
        if debug_history is None:
            return
        debug_history['criteria'] = [float(c) for c
                                     in debug_history['criteria']]
        debug_history['lut_shape_cost'] = [
            t.cpu().numpy() for t in debug_history['lut_shape_cost']]

    def upload(self, labels):
        with stage_range('upload'):
            return torch.as_tensor(labels, dtype=torch.int64,
                                   device=self.dev)

    def fetch(self, labels_t):
        with stage_range('fetch'):
            return labels_t.cpu().numpy().astype(int)


# ----------------------------------------------------------------- greedy ---

def _flip_energy_changes(labels, lut_cost, node_weights, edges, evalid, pen,
                         coef_pairwise):
    """(K, C) energy *decrease* of flipping every node k to every class c,
    from two ``index_add_`` sums over the static edge list, in f32.

    :param labels: (K,) integer tensor
    :param lut_cost: (K, C) combined per-node class cost
        (coef_data*data + coef_shape*shape)
    :param node_weights: (K,) pixel counts
    :param edges: (E, 2) padded edge list; ``evalid``: (E,) bool
    :param pen: (C, C) transition penalty
    """
    lab = labels.to(torch.int64)
    dev = lab.device
    lut = torch.as_tensor(lut_cost, device=dev).to(torch.float32)
    k = lut.shape[0]
    w = torch.as_tensor(evalid, device=dev).to(torch.float32)
    pen_t = torch.as_tensor(pen, device=dev).to(torch.float32)
    e = torch.as_tensor(edges, device=dev).to(torch.int64)
    pa = pen_t[:, lab[e[:, 1]]].T * w[:, None]           # (E, C): pen(c, l_b)
    pb = pen_t[:, lab[e[:, 0]]].T * w[:, None]
    zeros = torch.zeros_like(lut)
    p_inc = zeros.index_add(0, e[:, 0], pa) + zeros.index_add(0, e[:, 1], pb)
    cur_cost = torch.gather(lut, 1, lab[:, None])
    p_cur = torch.gather(p_inc, 1, lab[:, None])
    nw = torch.as_tensor(node_weights, device=dev).to(torch.float32)
    delta = nw[:, None] * (lut - cur_cost) + coef_pairwise * (p_inc - p_cur)
    return -delta


def region_growing_shape_slic_greedy(
        slic, slic_prob_fg, centres, shape_model, shape_type='cdf',
        coef_data=1., coef_shape=1, coef_pairwise=1,
        prob_label_trans=(.1, .01), allow_obj_swap=True, greedy_tol=1e-3,
        dict_thresholds=None, nb_iter=999, debug_history=None,
        device='cuda'):
    """Greedy RG2Sp: each round scores every candidate flip at once and
    applies those within ``greedy_tol`` of the best; a round without a
    gain swaps the shape's axis, and seven such end the growth.

    :returns: (K,) numpy labels
    """
    thresholds = RG2SP_THRESHOLDS if dict_thresholds is None \
        else dict_thresholds
    st = _RGState(slic, slic_prob_fg, centres, shape_model, shape_type,
                  thresholds, device, 0.0)
    labels = st.labels
    list_swap_shift = [False]
    st.start_history(debug_history)
    pen = torch.as_tensor(_penalty_matrix(st.nb_obj + 1, prob_label_trans),
                          device=st.dev)
    coefs = (coef_data, coef_shape, coef_pairwise, prob_label_trans)
    for _ in range(nb_iter):
        labels = enforce_center_labels(st.slic, labels, st.centres_act)
        labels_t = st.upload(labels)
        st.record(debug_history, labels, labels_t, coefs)
        with stage_range('candidates'):
            cand = _candidate_masks(st.edges_t, st.evalid_t, labels_t,
                                    st.nb_obj, allow_obj_swap)
        st.update_shape(labels, list_swap_shift[-1])
        with stage_range('score'):
            lut_cost = coef_data * st.lut_data + coef_shape * st.lut_shape
            scores = _flip_energy_changes(labels_t, lut_cost, st.weights_t,
                                          st.edges_t, st.evalid_t, pen,
                                          coef_pairwise)
            scores = torch.where(cand, scores, -torch.inf)
            best_t = torch.amax(scores)
        with stage_range('fetch'):
            best = float(best_t)
        if not np.isfinite(best) or best < 0:
            if any(list_swap_shift[-7:]):
                break
            list_swap_shift.append(True)
            continue
        list_swap_shift.append(False)
        # apply every flip within the greedy tolerance of the best one
        with stage_range('score'):
            node_best_cls = torch.argmax(scores, dim=1)
            node_best = torch.gather(scores, 1, node_best_cls[:, None])[:, 0]
            flip = (node_best > 0) & ((best_t - node_best) / best_t
                                      < greedy_tol)
            labels_t = torch.where(flip, node_best_cls, labels_t)
        labels = st.fetch(labels_t)
    st.close_history(debug_history)
    return labels


# --------------------------------------------------------------- graphcut ---

def prepare_graphcut_variables(candidates, slic_points, slic_neighbours,
                               slic_weights, labels, nb_centres,
                               lut_data_cost, lut_shape_cost, coef_data,
                               coef_shape, coef_pairwise, prob_label_trans):
    """Boundary-band subgraph with its hard-clamped closure, in the
    reference's form (host): (vertexes, edges, edge weights, unary,
    pairwise).  The solver below uses the full-graph clamped formulation."""
    if np.max(candidates) >= len(slic_points):
        raise ValueError('max candidate idx: %d for %d centres'
                         % (np.max(candidates), len(slic_points)))
    unary_rows, vertexes, gc_edges = [], list(candidates), []
    for i, idx in enumerate(candidates):
        near_idx = slic_neighbours[idx]
        near_labels = labels[near_idx]
        cost = coef_data * lut_data_cost[idx] + coef_shape * lut_shape_cost[idx]
        row = slic_weights[idx] * cost
        for lb in range(len(row)):
            if lb not in near_labels:
                row[lb] = GC_REPLACE_INF
        unary_rows.append(row)
    unary = np.array(unary_rows)
    for i, idx in enumerate(candidates):
        for n_idx in slic_neighbours[idx]:
            if n_idx not in vertexes:
                vertexes.append(n_idx)
                u = np.full(unary.shape[-1], GC_REPLACE_INF)
                u[labels[n_idx]] = 0
                unary = np.vstack((unary, u))
            gc_edges.append((i, vertexes.index(n_idx)))

    min_unary = -np.log(MAX_UNARY_PROB)
    unary[unary < min_unary] = min_unary
    pts = np.asarray(slic_points)[vertexes]
    e = np.asarray(gc_edges)
    d = pts[e[:, 0]] - pts[e[:, 1]]
    dist = np.sqrt(np.sum(d * d, axis=1))
    spatial = dist / np.mean(dist)
    edge_weights = np.ones(len(gc_edges)) / spatial
    pairwise = _penalty_matrix(unary.shape[-1], prob_label_trans) * coef_pairwise
    pairwise[pairwise > MAX_PAIRWISE_COST] = MAX_PAIRWISE_COST
    return vertexes, e, edge_weights, unary, pairwise


def _infer_grid_cfg(slic):
    """The SLIC grid geometry of a label map, if it is one: labels of the
    default 2D SLIC lie within one tile of their pixel's tile for the
    ``slic_config`` that made them.  None for any other map (e.g. the
    dynamic-K compat mode), which keeps the edge-list solver."""
    from pyimsegm_tpu_torch.ops.slic import slic_config
    slic = np.asarray(slic)
    h, w = slic.shape
    k = int(np.max(slic)) + 1
    if k <= 1:
        return None
    s0 = int(round(math.sqrt(h * w / k)))
    for s in range(max(2, s0 - 2), s0 + 3):
        cfg = slic_config(h, w, s)
        if cfg.n_segments != k:
            continue
        gw, step = cfg.grid_w, cfg.step
        ty = np.arange(h)[:, None] // step
        tx = np.arange(w)[None, :] // step
        ly = slic // gw
        lx = slic - ly * gw
        if (np.abs(ly - ty) <= 1).all() and (np.abs(lx - tx) <= 1).all():
            return cfg
    return None


def _clamped_unary(cost, labels_t, cand_any, allowed_cls, min_unary):
    """f32 unary of a clamped round: candidates keep their weighted cost
    on the classes ``allowed_cls`` (plus their own), every other node is
    held to its label; float64 until the cast."""
    own = torch.nn.functional.one_hot(labels_t, cost.shape[1]).to(torch.bool)
    free = torch.where(allowed_cls | own, cost, GC_REPLACE_INF)
    held = torch.where(own, 0.0, GC_REPLACE_INF).to(cost.dtype)
    unary = torch.where(cand_any[:, None], free, held)
    return torch.clamp_min(unary, min_unary).to(torch.float32)


def region_growing_shape_slic_graphcut(
        slic, slic_prob_fg, centres, shape_model, shape_type='cdf',
        coef_data=1., coef_shape=1, coef_pairwise=2,
        prob_label_trans=(0.1, 0.03), optim_global=True, allow_obj_swap=True,
        dict_thresholds=None, nb_iter=999, debug_history=None,
        grid_cfg=None, device='cuda'):
    """GraphCut RG2Sp: each round a clamped MRF on the full superpixel
    graph (candidates keep their weighted data + shape costs on the labels
    of their neighbourhood, every other node is held to its label),
    solved on the device; the growth stops when a round changes nothing
    twice or returns to an earlier labelling.

    ``grid_cfg`` (the ``SlicConfig`` whose grid made ``slic``; inferred
    when None) routes the solves through the dense 25-neighbour grid solve
    (10 mean-field and 6 ICM iterations) over
    :func:`ops.grid.wgrid_from_edges` where the labels' K is the grid's;
    any other label map takes the edge-list ``solve_mrf`` (10 / 4 / 2 / 4
    / 2).

    :returns: (K,) numpy labels
    """
    thresholds = RG2SP_THRESHOLDS if dict_thresholds is None \
        else dict_thresholds
    st = _RGState(slic, slic_prob_fg, centres, shape_model, shape_type,
                  thresholds, device, 1e-9)
    k, nb_obj, dev = st.k, st.nb_obj, st.dev
    labels = st.labels
    labels_history = [np.zeros(k, dtype=int)]
    list_swap_shift = [False]
    st.start_history(debug_history)

    # static geometry of the clamped solves
    centers_t = torch.as_tensor(st.centers, device=dev)
    spatial = graph_ops.compute_spatial_dist(centers_t, st.edges_t,
                                             st.evalid_t, relative=True)
    edge_w = torch.where(st.evalid_t,
                         1.0 / torch.clamp_min(spatial, 1e-12), 0.0)
    pairwise = np.minimum(_penalty_matrix(nb_obj + 1, prob_label_trans)
                          * coef_pairwise, MAX_PAIRWISE_COST)
    pairwise = torch.as_tensor(pairwise, dtype=torch.float32, device=dev)
    min_unary = -np.log(MAX_UNARY_PROB)
    coefs = (coef_data, coef_shape, coef_pairwise, prob_label_trans)

    if grid_cfg is None:
        grid_cfg = _infer_grid_cfg(st.slic)
    wgrid = adj = None
    if grid_cfg is not None and grid_cfg.n_segments == k:
        from pyimsegm_tpu_torch.ops.grid import wgrid_from_edges
        wgrid = wgrid_from_edges(st.edges_t, st.evalid_t, edge_w, grid_cfg)
    else:
        adj = edge_adjacency(st.edges_t, edge_w, k)

    def solve_clamped(labels_t, cand_any, neigh):
        with stage_range('unary'):
            cost = (coef_data * st.lut_data + coef_shape * st.lut_shape) \
                * st.weights_t[:, None]
            unary = _clamped_unary(cost, labels_t, cand_any, neigh, min_unary)
        with stage_range('solve'):
            if wgrid is not None:
                from pyimsegm_tpu_torch.ops.grid import solve_mrf_grid
                out = solve_mrf_grid(unary, wgrid, pairwise, grid_cfg,
                                     n_mf_iters=10, n_icm_iters=6)
            else:
                # almost every node is held: the light schedule
                out = solve_mrf(unary, st.edges_t, edge_w, pairwise,
                                n_mf_iters=10, n_icm_iters=4,
                                n_expand_rounds=2, n_move_steps=4,
                                n_chains=2, adj=adj)
        return out.to(torch.int64)

    for _ in range(nb_iter):
        labels = enforce_center_labels(st.slic, labels, st.centres_act)
        labels_t = st.upload(labels)
        st.record(debug_history, labels, labels_t, coefs)
        with stage_range('candidates'):
            neigh = _neighbor_class_mask(st.edges_t, st.evalid_t, labels_t,
                                         nb_obj + 1)
            cand = _candidate_masks(st.edges_t, st.evalid_t, labels_t,
                                    nb_obj, allow_obj_swap, neigh=neigh)
        st.update_shape(labels, list_swap_shift[-1])

        if optim_global:
            labels_gc_t = solve_clamped(labels_t, cand.any(dim=1), neigh)
        else:
            labels_gc_t = labels_t
            for i in range(nb_obj):
                labels_gc_t = solve_clamped(labels_gc_t, cand[:, i + 1],
                                            neigh)
        labels_gc = st.fetch(labels_gc_t)

        if np.array_equal(labels, labels_gc):
            existed = any(np.array_equal(labels_gc, h)
                          for h in labels_history[:-1])
            if any(list_swap_shift[-2:]) or existed:
                break
            list_swap_shift.append(True)
        else:
            list_swap_shift.append(False)
        labels = labels_gc
        labels_history.append(labels.copy())

    st.close_history(debug_history)
    return labels


# --------------------------------------------- one-shot object GraphCut -----

def _radial_shape(dist, shape_mean, shape_std, device):
    """``1 - norm_cdf(floor(dist)) + 1e-9`` (f32 CDF, as a float64 array)."""
    samples = torch.arange(int(np.max(dist) + 1), dtype=torch.float32,
                           device=device)
    cum = (1.0 - sp_ops.norm_cdf(samples, float(shape_mean),
                                 float(shape_std)) + 1e-9).cpu().numpy()
    return cum[dist.astype(int)]


def object_segmentation_graphcut_slic(
        slic, segm, centres, labels_fg_prob=(0.1, 0.9), gc_regul=1,
        edge_coef=0.5, edge_type='model', coef_shape=0.,
        shape_mean_std=(50., 10.), add_neighbours=False, debug_visual=None,
        device='cuda'):
    """One-shot multi-object GraphCut on the superpixel graph: fg / bg
    unaries from the label table, an optional Gaussian radial shape prior,
    solved by the edge-list ``solve_mrf`` on ``device``.

    :returns: (K,) int32 numpy labels
    """
    slic_t = as_tensor(slic, device)
    slic = slic_t.cpu().numpy()
    segm = np.asarray(segm)
    if np.min(labels_fg_prob) >= 1:
        raise ValueError('non label can be strictly 1')
    if segm.max() > len(labels_fg_prob):
        raise ValueError('table of label prob is shorter then the nb of labels'
                         ' in segmentation')
    if not list(centres):
        raise ValueError('at least one center has to be given')
    dev = slic_t.device
    label_hist = histogram_regions_labels_norm(slic, segm)
    labels = np.argmax(label_hist, axis=1)
    labels_fg_prob = np.asarray(labels_fg_prob, float)
    labels_bg_prob = 1.0 - labels_fg_prob
    centres = [np.round(c).astype(int) for c in centres]
    k = int(slic.max()) + 1
    _, edges, evalid, centers_np, _ = _graph_setup(slic_t)
    slic_points = centers_np

    nb_cls = len(centres) + 1
    proba = np.ones((k, nb_cls))
    proba[:, 0] = labels_bg_prob[labels]
    for i in range(len(centres)):
        proba[:, i + 1] = labels_fg_prob[labels]

    shape = np.ones((k, nb_cls))
    if coef_shape > 0:
        shape_mean, shape_std = shape_mean_std
        shape[:, 0] = labels_bg_prob[labels]
        for i, centre in enumerate(centres):
            diff = slic_points - np.asarray(centre, float)[None, :]
            dist = np.sqrt(np.sum(diff ** 2, axis=1))
            shape[:, i + 1] = _radial_shape(dist, shape_mean, shape_std, dev)

    unary = -np.log(proba) - coef_shape * np.log(shape)
    edge_mask_off = np.zeros(len(edges), dtype=bool)
    for i, pos in enumerate(centres):
        vertex = slic[tuple(pos)]
        unary[vertex, i + 1] = 0
        if add_neighbours:
            sel = evalid & ((edges[:, 0] == vertex) | (edges[:, 1] == vertex))
            for v in edges[sel].ravel():
                unary[v, i + 1] = 0
            edge_mask_off |= sel
    min_unary = -np.log(MAX_UNARY_PROB)
    unary[unary < min_unary] = min_unary

    edges_t = torch.as_tensor(edges.astype(np.int64), device=dev)
    if edge_type == 'model':
        proba_fg = labels_fg_prob[labels]
        dist = np.abs(proba_fg[edges[:, 0]] - proba_fg[edges[:, 1]])
        std = np.std(dist[evalid])
        weights = np.exp(-dist / max(2 * std ** 2, 1e-12))
        spatial = graph_ops.compute_spatial_dist(
            torch.as_tensor(centers_np, device=dev), edges_t,
            torch.as_tensor(evalid, device=dev), relative=True).cpu().numpy()
        weights = weights / np.maximum(spatial, 1e-12)
    else:
        weights = np.ones(len(edges))
    weights *= edge_coef
    weights[~evalid | edge_mask_off] = 0.0

    pairwise = (1 - np.eye(nb_cls)) * gc_regul
    if np.isscalar(gc_regul) and gc_regul <= 0:
        graph_labels = np.argmin(unary, axis=1).astype(np.int32)
    else:
        graph_labels = solve_mrf(
            torch.as_tensor(unary, dtype=torch.float32, device=dev), edges_t,
            torch.as_tensor(weights, dtype=torch.float32, device=dev),
            torch.as_tensor(pairwise, dtype=torch.float32,
                            device=dev)).cpu().numpy()

    if debug_visual is not None:
        debug_visual['unary_imgs'] = [unary[:, i][slic]
                                      for i in range(unary.shape[-1])]
    return graph_labels


def _grid_edges(height, width):
    idx = np.arange(height * width).reshape(height, width)
    ev = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    eh = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    return np.concatenate([ev, eh], axis=0)


def object_segmentation_graphcut_pixels(
        segm, centres, labels_fg_prob=(0.1, 0.9), gc_regul=1, seed_size=0,
        coef_shape=0., shape_mean_std=(50., 10.), debug_visual=None,
        device='cuda'):
    """One-shot multi-object GraphCut on the pixel grid: the conn4 edge
    list of every pixel, solved by ``solve_mrf`` on ``device`` (4 expansion
    rounds, 2 chains).

    :returns: (H, W) int32 numpy object map
    """
    segm_t = as_tensor(segm, device)
    dev = segm_t.device
    segm = segm_t.cpu().numpy()
    if np.min(labels_fg_prob) >= 1:
        raise ValueError('non label can be strictly 1')
    if segm.max() > len(labels_fg_prob):
        raise ValueError('table of label proba is shorter then the nb of'
                         ' labels in segmentation')
    if not list(centres):
        raise ValueError('at least one center has to be given')
    height, width = segm.shape
    labels_fg_prob = np.asarray(labels_fg_prob, float)
    labels_bg_prob = 1.0 - labels_fg_prob
    centres = [np.round(c).astype(int) for c in centres]
    nb_cls = len(centres) + 1

    proba = np.ones((height, width, nb_cls))
    proba[:, :, 0] = labels_bg_prob[segm]
    for i in range(len(centres)):
        proba[:, :, i + 1] = labels_fg_prob[segm]

    shape = np.ones((height, width, nb_cls))
    if coef_shape > 0:
        shape_mean, shape_std = shape_mean_std
        shape[:, :, 0] = labels_bg_prob[segm]
        grid_r, grid_c = np.meshgrid(np.arange(height), np.arange(width),
                                     indexing='ij')
        for i, centre in enumerate(centres):
            dist = np.sqrt((grid_r - centre[0]) ** 2 + (grid_c - centre[1]) ** 2)
            shape[:, :, i + 1] = _radial_shape(dist, shape_mean, shape_std,
                                               dev)

    unary = -np.log(proba) - coef_shape * np.log(shape)
    for i, pos in enumerate(centres):
        if seed_size > 0:
            from pyimsegm_tpu_torch.ops.morphology import disk
            selem = np.asarray(disk(seed_size), bool)
            mask = np.zeros(segm.shape, dtype=bool)
            mask[pos[0] - seed_size:pos[0] + seed_size + 1,
                 pos[1] - seed_size:pos[1] + seed_size + 1] = selem
            mask &= segm > 0
            unary[mask, i + 1] = 0
        else:
            unary[pos[0], pos[1], i + 1] = 0

    pairwise = (1 - np.eye(nb_cls)) * gc_regul
    if np.isscalar(gc_regul) and gc_regul <= 0:
        segm_obj = np.argmin(unary, axis=-1).astype(np.int32)
    else:
        edges = torch.as_tensor(_grid_edges(height, width), device=dev)
        with stage_range('solve'):
            out = solve_mrf(
                torch.as_tensor(unary.reshape(-1, nb_cls),
                                dtype=torch.float32, device=dev), edges,
                torch.ones(len(edges), dtype=torch.float32, device=dev),
                torch.as_tensor(pairwise, dtype=torch.float32, device=dev),
                n_expand_rounds=4, n_chains=2)
        segm_obj = out.cpu().numpy().reshape(height, width).astype(np.int32)

    if debug_visual is not None:
        debug_visual['unary_imgs'] = [unary[:, :, i]
                                      for i in range(unary.shape[-1])]
    return segm_obj


logging.getLogger(__name__).addHandler(logging.NullHandler())
