"""Clustering primitives without sklearn (port of
``pyimsegm_tpu.models.clustering``): DBSCAN for the centre candidates,
mean shift, bandwidth estimation and spectral clustering for the ray-shape
models of RG2Sp.

Distance matrices are one (N, M) product on the points' device; the
component and mode bookkeeping is small and stays on the host.
"""

import numpy as np
import torch

from pyimsegm_tpu_torch.utils.device import as_tensor


def pairwise_dist2(x, y=None, device='cuda'):
    """(N, M) squared euclidean distances ``|x|^2 + |y|^2 - 2 x.y`` in f32,
    clipped at 0; a tensor runs on its device, anything else on
    ``device``."""
    x = as_tensor(x, device).to(torch.float32)
    y = x if y is None else as_tensor(y, x.device).to(torch.float32)
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def dbscan(points, eps, min_samples=1, device='cuda'):
    """Density-based clustering; label -1 = noise.

    Core points have >= ``min_samples`` neighbours within ``eps`` (self
    included); clusters are the connected components of the core points,
    and a border point joins the cluster of the core point that reaches it
    first.

    :param points: (N, D)
    :returns: (N,) int labels
    """
    points = np.asarray(points, float)
    n = len(points)
    if n == 0:
        return np.zeros(0, dtype=int)
    d2 = pairwise_dist2(points, device=device).cpu().numpy()
    adj = d2 <= eps * eps
    core = adj.sum(axis=1) >= min_samples

    labels = np.full(n, -1, dtype=int)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = [i]
        labels[i] = cluster
        while stack:
            p = stack.pop()
            if not core[p]:
                continue
            for q in np.nonzero(adj[p])[0]:
                if labels[q] == -1:
                    labels[q] = cluster
                    stack.append(q)
        cluster += 1
    return labels


def estimate_bandwidth(points, quantile=0.3, device='cuda'):
    """Mean over the points of the distance to their ``quantile * N``-th
    nearest neighbour (sklearn's heuristic)."""
    points = np.asarray(points, float)
    k = max(1, int(len(points) * quantile))
    d = np.sqrt(pairwise_dist2(points, device=device).cpu().numpy())
    part = np.sort(d, axis=1)[:, :k + 1]          # self at 0 included
    return float(np.mean(part[:, -1]))


def mean_shift(points, bandwidth=None, max_iter=300, device='cuda'):
    """Flat-kernel mean shift from every point; returns (modes, labels),
    the modes ordered by their number of points (densest first).  A host
    check of the largest move each iteration stops it."""
    points = np.asarray(points, float)
    if bandwidth is None or bandwidth <= 0:
        bandwidth = estimate_bandwidth(points, device=device)
        if bandwidth <= 0:
            bandwidth = 1.0
    x = as_tensor(points, device).to(torch.float32)

    seeds = x
    for _ in range(max_iter):
        w = (pairwise_dist2(seeds, x) <= bandwidth * bandwidth).to(
            torch.float32)
        cnt = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
        new = (w @ x) / cnt
        done = float(torch.max(torch.abs(new - seeds))) < 1e-3 * bandwidth
        seeds = new
        if done:
            break
    seeds = seeds.cpu().numpy()

    # merge modes closer than the bandwidth, in the reference's visiting
    # order (numpy's argsort of equal keys)
    modes = []
    for s in seeds[np.argsort(-np.ones(len(seeds)))]:
        if not any(np.sum((s - m) ** 2) <= bandwidth * bandwidth
                   for m in modes):
            modes.append(s)
    modes = np.asarray(modes)
    d2 = pairwise_dist2(points, modes, device=device).cpu().numpy()
    labels = np.argmin(d2, axis=1)
    counts = np.bincount(labels, minlength=len(modes))
    remap = np.argsort(np.argsort(-counts))
    return modes[np.argsort(-counts)], remap[labels]


def spectral_clustering(points, n_clusters, gamma=1.0, seed=0,
                        device='cuda'):
    """Normalised spectral clustering with an RBF affinity: the
    eigenvectors of the smallest ``n_clusters`` eigenvalues of the
    normalised Laplacian, rows normalised, then k-means from a
    ``torch.Generator`` seeded with ``seed``."""
    from pyimsegm_tpu_torch.models.gmm import kmeans_fit

    points = np.asarray(points, float)
    d2 = pairwise_dist2(points, device=device)
    gamma = gamma / points.shape[1]               # sklearn: 1 / n_features
    aff = torch.exp(-gamma * d2)
    deg = torch.sum(aff, dim=1)
    d_inv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
    lap = torch.eye(len(points), device=d2.device) \
        - d_inv[:, None] * aff * d_inv[None, :]
    _, vecs = torch.linalg.eigh(lap)
    emb = vecs[:, :n_clusters]
    emb = emb / torch.clamp_min(torch.linalg.norm(emb, dim=1, keepdim=True),
                                1e-12)
    gen = torch.Generator(device=d2.device).manual_seed(int(seed))
    _, labels = kmeans_fit(gen, emb.to(torch.float32),
                           torch.ones(len(points), device=d2.device),
                           n_clusters)
    return labels.cpu().numpy()
