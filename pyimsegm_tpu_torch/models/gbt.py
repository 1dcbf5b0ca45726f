"""Histogram gradient-boosted trees, fitted and evaluated on the tensors'
device (port of ``pyimsegm_tpu.models.gbt``).

Multiclass softmax boosting: each round fits one regression tree per class
on the gradient ``p - onehot(y)`` and hessian ``p (1 - p)``.  Features are
quantile-binned once (``n_bins`` bins from weighted quantiles); a tree grows
level by level, all nodes of a level at once, from the (node, feature, bin)
histograms of the gradient and hessian; a cumulative sum over the bins
gives every candidate split's left and right sums, and one argmax per node
picks the best (feature, bin) by the Newton gain.  Leaves are ``-G / (H +
lambda)``.  Prediction walks every (round, class) tree and adds
``learning_rate * leaf`` to the class log-prior.

The fit draws nothing at random.  Its histograms are a one-hot matmul in
float64 (bins one-hot per feature, nodes one-hot weighted by the gradient
and hessian), a reduction in a fixed order, so a fit on the card gives the
same parameters every run (a scatter-add of float gradients would add in
the order of the card's atomics).  A leading fold axis batches the fit over
CV folds, as the reference vmaps it.  Prediction with carried parameters
gives the JAX package's probabilities.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

_BIG = 3.4e38


class GBTParams(NamedTuple):
    feat: torch.Tensor        # (..., R, C, n_internal) int64 split feature
    thr: torch.Tensor         # (..., R, C, n_internal) f32 split threshold
    leaf: torch.Tensor        # (..., R, C, n_leaves) f32 leaf value
    base_score: torch.Tensor  # (..., C) initial raw score (log prior)
    learning_rate: float
    depth: int

    @property
    def n_classes(self):
        return self.base_score.shape[-1]


def _quantile_bin_edges(x, sample_weight, n_bins):
    """(B, F, n_bins - 1) interior bin edges from weighted quantiles; rows
    of weight 0 are pushed to 3.4e38 before the sort.

    :param x: (B, N, F) f32
    :param sample_weight: (B, N)
    """
    xq = torch.where(sample_weight[..., None] > 0, x,
                     torch.tensor(_BIG, dtype=torch.float32, device=x.device))
    xs = torch.sort(xq, dim=1).values                          # (B, N, F)
    n_real = torch.clamp_min(torch.sum(sample_weight > 0, dim=1), 1)
    q = (torch.arange(1, n_bins, dtype=torch.float32, device=x.device)
         / n_bins) * (n_real.to(torch.float32)[:, None] - 1.0)  # (B, nb-1)
    idx = torch.clamp(q.to(torch.int32), 0, x.shape[1] - 1).to(torch.int64)
    edges = torch.take_along_dim(xs, idx[..., None], dim=1)    # (B, nb-1, F)
    return edges.transpose(1, 2)                               # (B, F, nb-1)


def _bin_features(x, edges):
    """(B, N, F) bin index: the count of edges <= value."""
    return torch.sum(x[..., None] >= edges[:, None], dim=-1)


def _fit_level_trees(bins1h, bins, g, h, n_bins, depth, reg_lambda,
                     edges_full):
    """One regression tree per (fold, class) on (g, h).

    :param bins1h: (B, N, F * n_bins) f64 one-hot bins
    :param bins: (B, N, F) int64
    :param g, h: (B, C, N) f32 gradient / hessian (hessian 0 = padded slot)
    :param edges_full: (B, F, n_bins) thresholds, ``edges_full[b, f, k]``
        meaning "bin <= k goes left"
    :returns: (feat (B, C, n_internal), thr (B, C, n_internal), leaf (B, C,
        n_leaves))
    """
    nf, n, f = bins.shape[0], bins.shape[1], bins.shape[2]
    c = g.shape[1]
    dev = g.device
    n_internal = 2 ** depth - 1
    node = torch.zeros((nf, c, n), dtype=torch.int64, device=dev)
    feat_store = torch.zeros((nf, c, n_internal), dtype=torch.int64,
                             device=dev)
    thr_store = torch.full((nf, c, n_internal), -_BIG, dtype=torch.float32,
                           device=dev)
    gh = torch.stack([g, h], dim=2).to(torch.float64)          # (B, C, 2, N)
    valid_bin = torch.arange(n_bins, device=dev) < n_bins - 1
    fidx = torch.arange(nf, device=dev)[:, None, None]
    for d in range(depth):
        level_nodes, level_off = 2 ** d, 2 ** d - 1
        seg = node - level_off                                 # (B, C, N)
        onehot = F.one_hot(seg, level_nodes).to(torch.float64)  # (B,C,N,L)
        # (B, C, 2, L, N) @ (B, 1, N, F*nb): the level's histograms
        w = gh[:, :, :, None, :] * onehot.permute(0, 1, 3, 2)[:, :, None]
        hist = torch.matmul(w.reshape(nf, c * 2 * level_nodes, n), bins1h)
        hist = hist.to(torch.float32).reshape(nf, c, 2, level_nodes, f,
                                              n_bins)
        cum = torch.cumsum(hist, dim=-1)                       # left stats
        gl, hl = cum[:, :, 0], cum[:, :, 1]                    # (B,C,L,F,nb)
        gt, ht = cum[:, :, 0, ..., -1:], cum[:, :, 1, ..., -1:]
        gr, hr = gt - gl, ht - hl

        def half_gain(gs, hs):
            return gs * gs / (hs + reg_lambda)

        gain = (half_gain(gl, hl) + half_gain(gr, hr)) - half_gain(gt, ht)
        valid = valid_bin & (hl > 1e-12) & (hr > 1e-12)
        gain = torch.where(valid, gain, float('-inf'))
        flat = gain.reshape(nf, c, level_nodes, f * n_bins)
        best = torch.argmax(flat, dim=-1)                      # (B, C, L)
        best_gain = torch.take_along_dim(flat, best[..., None], dim=-1)[..., 0]
        best_feat = best // n_bins
        best_bin = best % n_bins
        thr = edges_full[fidx, best_feat, best_bin]
        no_split = ~torch.isfinite(best_gain) | (best_gain <= 0.0)
        thr = torch.where(no_split, -_BIG, thr)
        feat_store[..., level_off:level_off + level_nodes] = best_feat
        thr_store[..., level_off:level_off + level_nodes] = thr
        # descend: bin <= best_bin goes left; unsplit nodes route all right
        nfeat = torch.take_along_dim(best_feat, seg, dim=-1)   # (B, C, N)
        bv = torch.take_along_dim(bins[:, None].expand(nf, c, n, f),
                                  nfeat[..., None], dim=-1)[..., 0]
        left = (bv <= torch.take_along_dim(best_bin, seg, dim=-1)) \
            & ~torch.take_along_dim(no_split, seg, dim=-1)
        node = 2 * node + torch.where(left, 1, 2)
    n_leaves = 2 ** depth
    onehot = F.one_hot(node - n_internal, n_leaves).to(torch.float64)
    sums = torch.matmul(gh, onehot).to(torch.float32)          # (B, C, 2, L)
    leaf = -sums[:, :, 0] / (sums[:, :, 1] + reg_lambda)
    return feat_store, thr_store, leaf


def _walk(feat, thr, depth, x):
    """Leaf index of every sample in every tree.

    :param feat, thr: (B, T, n_internal)
    :param x: (B, N, F)
    :returns: (B, T, N) leaf ids
    """
    nb, t = feat.shape[:2]
    n, f = x.shape[1:]
    feat = feat.to(torch.int64)
    node = torch.zeros((nb, t, n), dtype=torch.int64, device=x.device)
    xe = x[:, None].expand(nb, t, n, f)
    for _ in range(depth):
        fidx = torch.take_along_dim(feat, node, dim=2)
        tv = torch.take_along_dim(thr, node, dim=2)
        fv = torch.take_along_dim(xe, fidx[..., None], dim=3)[..., 0]
        node = 2 * node + torch.where(fv < tv, 1, 2)
    return node - (2 ** depth - 1)


def gbt_fit(x, y, sample_weight, n_classes, n_rounds=64, depth=4,
            learning_rate=0.1, n_bins=64, reg_lambda=1.0):
    """Fit multiclass histogram GBT.

    :param x: (N, F) or (B, N, F) float features (one matrix per fold)
    :param y: (N,) integer class ids
    :param sample_weight: (N,) or (B, N), 0 = padded slot
    :returns: :class:`GBTParams`, with a leading (B,) axis when ``x`` or
        ``sample_weight`` has one
    """
    batched = x.ndim == 3 or sample_weight.ndim == 2
    x = x.to(torch.float32)
    w = sample_weight.to(torch.float32)
    nf = max(x.shape[0] if x.ndim == 3 else 1, w.shape[0] if w.ndim == 2
             else 1)
    x = x.expand(nf, *x.shape[-2:]) if x.ndim == 3 else \
        x.expand(nf, *x.shape)
    w = w.expand(nf, w.shape[-1])
    _, n, f = x.shape
    dev = x.device
    onehot = F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)
    onehot = onehot[None] * w[..., None]                       # (B, N, C)

    edges = _quantile_bin_edges(x, w, n_bins)                  # (B, F, nb-1)
    bins = _bin_features(x, edges)                             # (B, N, F)
    bins1h = torch.zeros((nf, n, f * n_bins), dtype=torch.float64,
                         device=dev).scatter_(
        2, bins + torch.arange(f, device=dev) * n_bins, 1.0)
    edges_full = torch.cat([edges, torch.full((nf, f, 1), _BIG,
                                              device=dev)], dim=2)

    prior = torch.sum(onehot, dim=1)                           # (B, C)
    base = torch.log(torch.clamp_min(
        prior / torch.clamp_min(torch.sum(prior, dim=1, keepdim=True),
                                1e-10), 1e-10))
    scores = base[:, None, :].expand(nf, n, n_classes)
    feats, thrs, leaves = [], [], []
    for _ in range(n_rounds):
        p = torch.softmax(scores, dim=-1)
        g = (p * w[..., None] - onehot).transpose(1, 2)        # (B, C, N)
        h = (p * (1.0 - p) * w[..., None]).transpose(1, 2)
        feat, thr, leaf = _fit_level_trees(bins1h, bins, g, h, n_bins, depth,
                                           reg_lambda, edges_full)
        lv = torch.take_along_dim(leaf, _walk(feat, thr, depth, x), dim=2)
        scores = scores + learning_rate * lv.transpose(1, 2)   # (B, N, C)
        feats.append(feat)
        thrs.append(thr)
        leaves.append(leaf)
    out = GBTParams(torch.stack(feats, 1), torch.stack(thrs, 1),
                    torch.stack(leaves, 1), base, learning_rate, depth)
    if batched:
        return out
    return GBTParams(out.feat[0], out.thr[0], out.leaf[0], out.base_score[0],
                     learning_rate, depth)


def _gbt_raw_scores(feat, thr, leaf, base, lr, depth, x):
    """(N, C) raw scores, or (B, N, C) with batched parameters and x."""
    batched = feat.ndim == 4
    if not batched:
        feat, thr, leaf, base, x = feat[None], thr[None], leaf[None], \
            base[None], x[None]
    x = x.to(torch.float32)
    nb, r, c, _ = feat.shape
    n = x.shape[-2]
    x = x.expand(nb, n, x.shape[-1])
    fr = feat.reshape(nb, r * c, -1)
    tr = thr.reshape(nb, r * c, -1)
    lv = leaf.reshape(nb, r * c, -1)
    vals = torch.take_along_dim(lv, _walk(fr, tr, depth, x), dim=2)
    scores = torch.sum(vals.reshape(nb, r, c, n), dim=1).transpose(1, 2)
    out = base[:, None, :] + lr * scores
    return out if batched else out[0]


def gbt_predict_proba(params: GBTParams, x):
    """(N, C) softmax class probabilities."""
    raw = _gbt_raw_scores(params.feat, params.thr, params.leaf,
                          params.base_score, params.learning_rate,
                          int(params.depth), x)
    return torch.softmax(raw, dim=-1)
