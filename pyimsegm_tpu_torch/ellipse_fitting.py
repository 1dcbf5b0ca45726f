"""Ellipse models and segmentation-criterion RANSAC (port of
``pyimsegm_tpu.ellipse_fitting``).

An ellipse estimate is the direct (Halir-Flusser) conic least squares, a
small float64 eigenproblem on the host.  The O(N) parts run on the device:
the inside-ellipse test and the area-likelihood criterion of every RANSAC
trial over all points in one batch (:func:`_criterion_batch`), and the
residual distances to a dense parametric sampling of the ellipse
(:func:`_residual_dist`).  The RANSAC trials are drawn by
``np.random.choice`` from numpy's global state, so one ``np.random.seed``
gives the reference's trials.
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.ops.ray import (  # noqa: F401
    compute_ray_features_segm_2d,
    ray_features_positions_core,
    reconstruct_ray_features_2d,
    reduce_close_points,
)
from pyimsegm_tpu_torch.utils.device import as_tensor

#: minimal expected ellipse diameter
MIN_ELLIPSE_DAIM = 25.
#: background smoothing structure element size
STRUC_ELEM_BG = 15
#: foreground smoothing structure element size
STRUC_ELEM_FG = 5


# ------------------------------------------------------------ geometry -----

def ellipse_inside_mask(points, params):
    """(N,) bool: points inside the ellipse ``(xc, yc, a, b, theta)``."""
    xc, yc, a, b, phi = params
    pts = np.asarray(points, float)
    r = pts[:, 0] - xc
    c = pts[:, 1] - yc
    d1 = ((r * np.cos(phi) + c * np.sin(phi)) / a) ** 2
    d2 = ((r * np.sin(phi) - c * np.cos(phi)) / b) ** 2
    return (d1 + d2) <= 1


def ellipse_fill_coords(c1, c2, a, b, phi, shape=None):
    """Row / col coordinates of the ellipse's interior pixels."""
    rad = int(np.ceil(max(a, b)))
    r0, c0 = int(round(c1)), int(round(c2))
    rr, cc = np.meshgrid(np.arange(r0 - rad, r0 + rad + 1),
                         np.arange(c0 - rad, c0 + rad + 1), indexing='ij')
    pts = np.stack([rr.ravel(), cc.ravel()], axis=1)
    inside = ellipse_inside_mask(pts, (c1, c2, a, b, phi))
    rr, cc = pts[inside, 0], pts[inside, 1]
    if shape is not None:
        ok = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
        rr, cc = rr[ok], cc[ok]
    return rr, cc


def ellipse_perimeter_coords(c1, c2, a, b, phi, nb=720, shape=None):
    """Integer perimeter coordinates by dense parametric sampling."""
    t = np.linspace(0, 2 * np.pi, nb, endpoint=False)
    rr = np.round(c1 + a * np.cos(phi) * np.cos(t)
                  - b * np.sin(phi) * np.sin(t)).astype(int)
    cc = np.round(c2 + a * np.sin(phi) * np.cos(t)
                  + b * np.cos(phi) * np.sin(t)).astype(int)
    if shape is not None:
        ok = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
        rr, cc = rr[ok], cc[ok]
    return rr, cc


def _fit_conic(points):
    """Numerically stable direct ellipse LSQ (Halir & Flusser 1998), host
    float64.

    :returns: (xc, yc, a, b, theta) or None when degenerate
    """
    pts = np.asarray(points, float)
    if len(pts) < 5:
        return None
    x = pts[:, 0]
    y = pts[:, 1]
    mx, my = x.mean(), y.mean()
    x = x - mx
    y = y - my
    d1 = np.stack([x * x, x * y, y * y], axis=1)
    d2 = np.stack([x, y, np.ones_like(x)], axis=1)
    s1 = d1.T @ d1
    s2 = d1.T @ d2
    s3 = d2.T @ d2
    try:
        t_mat = -np.linalg.solve(s3, s2.T)
    except np.linalg.LinAlgError:
        return None
    m = s1 + s2 @ t_mat
    m_red = np.array([m[2] / 2.0, -m[1], m[0] / 2.0])
    try:
        evals, evecs = np.linalg.eig(m_red)
    except np.linalg.LinAlgError:
        return None
    cond = 4 * evecs[0] * evecs[2] - evecs[1] ** 2
    ok = np.where(np.isreal(evals) & (cond > 0))[0]
    if len(ok) == 0:
        return None
    a1 = np.real(evecs[:, ok[0]])
    a2 = t_mat @ a1
    av, bv, cv = a1
    dv, ev, fv = a2

    den = bv * bv - 4 * av * cv
    if den >= 0:
        return None
    xc = (2 * cv * dv - bv * ev) / den
    yc = (2 * av * ev - bv * dv) / den
    num = 2 * (av * ev * ev + cv * dv * dv + fv * bv * bv
               - bv * dv * ev - 4 * av * cv * fv)
    root = np.sqrt((av - cv) ** 2 + bv * bv)
    major = -np.sqrt(max(num * (av + cv + root), 0)) / den
    minor = -np.sqrt(max(num * (av + cv - root), 0)) / den
    if major <= 0 or minor <= 0:
        return None
    # canonical form: first radius = major axis, theta = its direction
    if bv == 0:
        theta = 0.0 if av < cv else np.pi / 2
    else:
        theta = np.arctan2(cv - av - root, bv)
    return np.array([xc + mx, yc + my, major, minor, theta])


def _criterion_batch(params, points, weights, labels, table_q):
    """Area-likelihood criterion of a batch of ellipses, f32 on the
    device of ``points``.

    :param params: (T, 5) ellipse rows; points (N, 2); weights (W,);
        labels (N,) int; table_q (2, L) ``-log`` probabilities (tensors)
    :returns: (T,) criteria
    """
    pts = points.to(torch.float32)
    lab = labels.to(torch.int64)
    diff_l = table_q[0] - table_q[1]                        # (L,)
    # the reference weights by ``weights[label]`` (label-indexed), not by
    # the point's index; kept for parity
    contrib = weights.to(torch.float32)[lab] * diff_l[lab]  # (N,)
    p = params.to(torch.float32)
    xc, yc, a, b, phi = (p[:, i:i + 1] for i in range(5))   # (T, 1)
    r = pts[None, :, 0] - xc
    c = pts[None, :, 1] - yc
    d1 = ((r * torch.cos(phi) + c * torch.sin(phi)) / a) ** 2
    d2 = ((r * torch.sin(phi) - c * torch.cos(phi)) / b) ** 2
    inside = (d1 + d2) <= 1
    return torch.sum(torch.where(inside, contrib[None, :],
                                 torch.zeros_like(d1)), dim=1)


def _residual_dist(params, points, nb_t=720):
    """Min distance from each point to ``nb_t`` samples of the ellipse,
    f32 on the device of ``points`` (the stand-in for a per-point Newton
    projection)."""
    p = params.to(torch.float32)
    xc, yc, a, b, phi = p[0], p[1], p[2], p[3], p[4]
    t = torch.arange(nb_t, dtype=torch.float32,
                     device=points.device) * float(2 * np.pi / nb_t)
    er = xc + a * torch.cos(phi) * torch.cos(t) \
        - b * torch.sin(phi) * torch.sin(t)
    ec = yc + a * torch.sin(phi) * torch.cos(t) \
        + b * torch.cos(phi) * torch.sin(t)
    pts = points.to(torch.float32)
    d2 = (pts[:, 0:1] - er[None, :]) ** 2 + (pts[:, 1:2] - ec[None, :]) ** 2
    return torch.sqrt(torch.amin(d2, dim=1))


def _table_q(table_prob):
    """(2, L) ``-log`` of the (foreground, background) probability table,
    as numpy float64 -> the reference's f32 values."""
    table_prob = np.array(table_prob, float)
    if 1 in (table_prob.ndim, table_prob.shape[0]):
        if table_prob.shape[0] == 1:
            table_prob = table_prob[0]
        table_prob = np.array([table_prob, 1. - table_prob])
    return table_prob, (-np.log(table_prob)).astype(np.float32)


class EllipseModelSegm:
    """Direct-LSQ ellipse with a segmentation likelihood criterion;
    ``params = (xc, yc, a, b, theta)``.

    :param device: where the residuals and the criterion run for numpy
        points
    """

    def __init__(self, device='cuda'):
        self.params = None
        self.device = device

    def estimate(self, points):
        params = _fit_conic(points)
        if params is None:
            return False
        self.params = params
        return True

    def predict_xy(self, t, params=None):
        if params is None:
            params = self.params
        xc, yc, a, b, phi = params
        t = np.asarray(t)
        xt = xc + a * np.cos(phi) * np.cos(t) - b * np.sin(phi) * np.sin(t)
        yt = yc + a * np.sin(phi) * np.cos(t) + b * np.cos(phi) * np.sin(t)
        return np.stack([xt, yt], axis=-1)

    def residuals(self, points):
        """(N,) numpy distances of the points to the ellipse."""
        pts = as_tensor(points, self.device)
        params = torch.as_tensor(np.asarray(self.params, np.float32),
                                 device=pts.device)
        return _residual_dist(params, pts).cpu().numpy()

    def criterion(self, points, weights, labels, table_prob=(0.1, 0.9)):
        """Sum over the points inside of ``w_label * (-log p_fg + log
        p_bg)``; negative favours the ellipse."""
        if not len(points) == len(weights) == len(labels):
            raise ValueError(
                'different sizes for points %i and weights %i and labels %i'
                % (len(points), len(weights), len(labels)))
        table_prob, table_q = _table_q(table_prob)
        if table_prob.shape[0] != 2:
            raise ValueError('table shape %r' % (table_prob.shape,))
        if np.max(labels) >= table_prob.shape[1]:
            raise ValueError('labels (%i) exceed the table %r'
                             % (np.max(labels), table_prob.shape))
        dev = self.device
        out = _criterion_batch(
            as_tensor(np.asarray(self.params, np.float32)[None], dev),
            as_tensor(np.asarray(points, np.float32), dev),
            as_tensor(np.asarray(weights, np.float32), dev),
            as_tensor(np.asarray(labels, np.int64), dev),
            as_tensor(table_q, dev))
        return float(out[0])


def ransac_segm(points, model_class, points_all, weights, labels, table_prob,
                min_samples, residual_threshold=1, max_trials=100,
                device='cuda'):
    """RANSAC that selects by the segmentation criterion, not by the
    inlier count.  The trial ellipses are fitted on the host (the subsets
    from ``np.random.choice``) and scored in one batched device call over
    ``points_all``; the best trial's inliers are refitted.

    :returns: (best model, inlier bool mask) or (None, None)
    """
    if isinstance(min_samples, float):
        if not 0 < min_samples <= 1:
            raise ValueError('`min_samples` as ratio must be in range (0, 1]')
        min_samples = int(min_samples * len(points))
    if not 0 < min_samples <= len(points):
        raise ValueError('`min_samples` must be in range (0, <nb-samples>]')
    if max_trials < 0:
        raise ValueError('`max_trials` must be greater than zero')

    points = np.array(points)
    _, table_q = _table_q(table_prob)

    trial_params = []
    for _ in range(max_trials):
        random_idxs = np.random.choice(len(points), min_samples, replace=False)
        params = _fit_conic(points[random_idxs])
        if params is None:
            continue
        trial_params.append(params)
    if not trial_params:
        return None, None

    fits = _criterion_batch(
        as_tensor(np.asarray(trial_params, np.float32), device),
        as_tensor(np.asarray(points_all, np.float32), device),
        as_tensor(np.asarray(weights, np.float32), device),
        as_tensor(np.asarray(labels, np.int64), device),
        as_tensor(table_q, device)).cpu().numpy()

    best_model = None
    best_inlier_num = 0
    best_model_fit = np.inf
    best_inliers = None
    for params, model_fit in zip(trial_params, fits):
        if model_fit >= best_model_fit:
            continue
        model = model_class()
        if hasattr(model, 'device'):
            model.device = device
        model.params = params
        best_model = model
        best_model_fit = model_fit
        inliers = np.abs(model.residuals(points)) < residual_threshold
        n_in = int(np.sum(inliers))
        if n_in > best_inlier_num:
            best_inliers = inliers
            best_inlier_num = n_in

    if best_inliers is not None:
        best_model.estimate(points[best_inliers])
    return best_model, best_inliers


# --------------------------------------------------------- boundary prep ---

def get_slic_points_labels(segm, img=None, slic_size=20, slic_regul=0.1,
                           device='cuda'):
    """SLIC of the image (by default the segmentation scaled to [0, 1] as a
    gray image), the superpixel centres and the segmentation label at each.

    :returns: (slic (H, W), centres (K, 2) int, labels (K,)) numpy
    """
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    from pyimsegm_tpu_torch.superpixels import superpixel_centers
    segm = np.asarray(segm)
    if img is None:
        img = segm / float(max(segm.max(), 1))
    slic = segment_slic_img2d(np.asarray(img, np.float32), sp_size=slic_size,
                              relative_compact=slic_regul, device=device)
    centers = superpixel_centers(slic, device=device).astype(int)
    labels = segm[centers[:, 0], centers[:, 1]]
    return slic, centers, labels


def add_overlap_ellipse(segm, ellipse_params, label, thr_overlap=1.):
    """Rasterise an ellipse into the instance map unless it overlaps an
    existing object by more than ``thr_overlap`` of the smaller one
    (host)."""
    if ellipse_params is None or len(ellipse_params) == 0:
        return segm
    segm = np.asarray(segm)
    c1, c2, h, w, phi = ellipse_params
    rr, cc = ellipse_fill_coords(int(c1), int(c2), int(h), int(w), phi,
                                 shape=segm.shape)
    mask = np.zeros(segm.shape, bool)
    mask[rr, cc] = True
    for lb in range(1, int(np.max(segm) + 1)):
        overlap = np.sum((segm == lb) & mask)
        sizes = [s for s in [np.sum(segm == lb), np.sum(mask)] if s > 0]
        if not sizes:
            return segm
        if float(overlap) / min(sizes) > thr_overlap:
            return segm
    segm = segm.copy()
    segm[mask] = label
    return segm


def _split_masks(seg, sel_bg, sel_fg, device):
    """:func:`split_segm_background_foreground` as bool tensors."""
    from scipy import ndimage
    from pyimsegm_tpu_torch.ops.morphology import binary_opening
    seg = np.asarray(seg)
    seg_bg = as_tensor(~ndimage.binary_fill_holes(seg > 0), device)
    if sel_bg > 0:
        seg_bg = binary_opening(seg_bg, int(sel_bg))
    seg_fg = as_tensor(seg == 1, device)
    if sel_fg > 0:
        seg_fg = binary_opening(seg_fg, int(sel_fg))
    return seg_bg, seg_fg


def split_segm_background_foreground(seg, sel_bg=STRUC_ELEM_BG,
                                     sel_fg=STRUC_ELEM_FG, device='cuda'):
    """Morphologically smoothed (background, foreground) masks: the
    background is what ``binary_fill_holes`` (host, scipy) leaves outside
    the objects, opened by a disk of ``sel_bg``; the foreground is label 1
    opened by ``sel_fg`` (the openings on the device).

    :returns: (background, foreground) bool numpy masks
    """
    return tuple(m.cpu().numpy() for m in _split_masks(seg, sel_bg, sel_fg,
                                                        device))


def _rays(seg_binary, centers, edge='up'):
    """(C, 72) numpy ray distances of all centres at 5 degrees."""
    pos = torch.as_tensor(np.asarray(centers, np.float32).reshape(-1, 2),
                          device=seg_binary.device)
    return ray_features_positions_core(seg_binary, pos, angle_step=5.0,
                                       edge=edge).cpu().numpy()


def prepare_boundary_points_ray_join(seg, centers, close_points=5,
                                     min_diam=MIN_ELLIPSE_DAIM,
                                     sel_bg=STRUC_ELEM_BG,
                                     sel_fg=STRUC_ELEM_FG, device='cuda'):
    """Union of the background-entry and foreground-exit ray hits."""
    seg_bg, seg_fg = _split_masks(seg, sel_bg, sel_fg, device)
    rays_bg, rays_fc = _rays(seg_bg, centers), _rays(seg_fg, centers, 'down')
    points_centers = []
    for center, ray_bg, ray_fc in zip(centers, rays_bg, rays_fc):
        ray_bg[ray_bg < min_diam] = min_diam
        points_bg = reduce_close_points(
            reconstruct_ray_features_2d(center, ray_bg), close_points)
        ray_fc[ray_fc < min_diam] = min_diam
        points_fc = reduce_close_points(
            reconstruct_ray_features_2d(center, ray_fc), close_points)
        points_centers.append(np.vstack((points_bg, points_fc)))
    return points_centers


def _rays_bg_fg_min(seg_bg, seg_fc, centers, min_diam):
    """(C, 2, 72) background-entry and foreground-exit rays, -1 -> inf,
    clipped below at ``min_diam``."""
    rays = np.stack([_rays(seg_bg, centers), _rays(seg_fc, centers, 'down')],
                    axis=1).astype(float)
    rays[rays < 0] = np.inf
    rays[rays < min_diam] = min_diam
    return rays


def prepare_boundary_points_ray_edge(seg, centers, close_points=5,
                                     min_diam=MIN_ELLIPSE_DAIM,
                                     sel_bg=STRUC_ELEM_BG,
                                     sel_fg=STRUC_ELEM_FG, device='cuda'):
    """The nearer of the background and foreground ray hits per angle."""
    seg_bg, seg_fc = _split_masks(seg, sel_bg, sel_fg, device)
    rays = _rays_bg_fg_min(seg_bg, seg_fc, centers, min_diam)
    return [reduce_close_points(reconstruct_ray_features_2d(
        center, np.min(r, axis=0)), close_points)
        for center, r in zip(centers, rays)]


def prepare_boundary_points_ray_mean(seg, centers, close_points=5,
                                     min_diam=MIN_ELLIPSE_DAIM,
                                     sel_bg=STRUC_ELEM_BG,
                                     sel_fg=STRUC_ELEM_FG, device='cuda'):
    """The mean of the background and foreground ray hits per angle, the
    nearer one where either is missing."""
    seg_bg, seg_fc = _split_masks(seg, sel_bg, sel_fg, device)
    points_centers = []
    for center, r in zip(centers,
                         _rays_bg_fg_min(seg_bg, seg_fc, centers, min_diam)):
        ray_min = np.min(r, axis=0)
        ray_mean = np.mean(r, axis=0)
        ray_mean[np.isinf(ray_mean)] = ray_min[np.isinf(ray_mean)]
        points_centers.append(reduce_close_points(
            reconstruct_ray_features_2d(center, ray_mean), close_points))
    return points_centers


def prepare_boundary_points_ray_dist(seg, centers, close_points=1,
                                     sel_bg=STRUC_ELEM_BG,
                                     sel_fg=STRUC_ELEM_FG, device='cuda'):
    """Background-entry ray hits, each assigned to its closest centre."""
    from pyimsegm_tpu_torch.models.clustering import pairwise_dist2
    seg_bg, _ = _split_masks(seg, sel_bg, sel_fg, device)
    points = []
    for center, ray in zip(centers, _rays(seg_bg, centers)):
        points += reduce_close_points(
            reconstruct_ray_features_2d(center, ray, 0), close_points).tolist()
    points = np.array(points)
    points[(points < 0) & (points > -1e-3)] = 0.
    d2 = pairwise_dist2(points, np.asarray(centers, float),
                        device=device).cpu().numpy()
    close_center = np.argmin(d2, axis=1)
    return [points[close_center == i] for i in range(close_center.max() + 1)]


def filter_boundary_points(segm, slic, device='cuda'):
    """Centres of the superpixels whose neighbourhood mixes background
    and foreground labels."""
    from pyimsegm_tpu_torch.ops import graph as graph_ops
    from pyimsegm_tpu_torch.superpixels import superpixel_centers
    segm = np.asarray(segm)
    slic_t = as_tensor(np.asarray(slic), device)
    k = int(slic_t.max()) + 1
    centers = superpixel_centers(slic_t).astype(int)
    labels = segm[centers[:, 0], centers[:, 1]]
    edges, valid = graph_ops.adjacency_edges_2d(slic_t, k)
    edges = edges.cpu().numpy()[valid.cpu().numpy()]
    nb_labels = labels.max() + 1
    neigh = np.zeros((k, nb_labels))
    np.add.at(neigh, (edges[:, 0], labels[edges[:, 1]]), 1)
    np.add.at(neigh, (edges[:, 1], labels[edges[:, 0]]), 1)
    neigh = neigh / np.maximum(neigh.sum(axis=1, keepdims=True), 1e-9)
    filter_bg = (labels == 0) & (neigh[:, 0] < 1)
    filter_fc = (labels == 1) & (neigh[:, 0] > 0)
    return centers[filter_bg | filter_fc]


def prepare_boundary_points_close(seg, centers, sp_size=25,
                                  relative_compact=0.3, device='cuda'):
    """Mixed-neighbourhood superpixel centres, split by their closest
    object centre."""
    from pyimsegm_tpu_torch.models.clustering import pairwise_dist2
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    seg = np.asarray(seg)
    slic = segment_slic_img2d(
        (seg / float(max(seg.max(), 1))).astype(np.float32), sp_size=sp_size,
        relative_compact=relative_compact, device=device)
    points_all = filter_boundary_points(seg, slic, device=device)
    d2 = pairwise_dist2(points_all.astype(float), np.asarray(centers, float),
                        device=device).cpu().numpy()
    close_center = np.argmin(d2, axis=1)
    return [points_all[close_center == i]
            for i in range(int(close_center.max() + 1))]
