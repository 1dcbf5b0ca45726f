"""Random forest, fitted and evaluated on the tensors' device (port of
``pyimsegm_tpu.models.forest``).

Trees grow breadth-first with all nodes of a depth level fitted at once:
node membership is an integer vector, each node draws ``n_candidates``
random (feature, threshold) splits (thresholds uniform within the node's
range of that feature, the extra-trees scheme), the splits are scored by
Gini impurity from class sums keyed on (tree, node), and the best one per
node wins by a strict ``<`` over the candidates in order.  Bagging is by
Poisson(1) weights per tree.  A leading fold axis batches the fit over CV
folds (the reference vmaps it): fold ``b`` sees its own sample weights and
its own standardised features.

The random draws come from an explicit ``torch.Generator`` and so differ
from the JAX package's, which the port is held to by accuracy.  For a fixed
generator seed on one device the fit is deterministic: the segment sums are
taken in float64 over integer-valued weights (the Poisson counts times 0/1
fold weights), so every sum is an exact integer whatever order the card's
atomics add in.  Prediction is exact: carried parameters give the JAX
package's probabilities.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

_BIG = 1e30


class ForestParams(NamedTuple):
    feat: torch.Tensor        # (..., T, n_internal) int64 split feature
    thr: torch.Tensor         # (..., T, n_internal) f32 split threshold
    leaf_proba: torch.Tensor  # (..., T, n_leaves, C) class distribution
    depth: int

    @property
    def n_classes(self):
        return self.leaf_proba.shape[-1]


def _seg_sum(values, seg_id, n_seg):
    """(n_seg, ...) f64 sums of (M, ...) ``values`` by ``seg_id``."""
    out = torch.zeros((n_seg,) + tuple(values.shape[1:]), dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, seg_id, values.to(torch.float64))


def _gini(cls, cnt):
    p = cls / torch.clamp_min(cnt, 1e-10)[:, None]
    return 1.0 - torch.sum(p * p, dim=1)


def forest_fit(generator, x, y, sample_weight, n_classes, n_trees=32, depth=8,
               n_candidates=8, bootstrap=True):
    """Fit one forest per fold.

    :param generator: ``torch.Generator`` on the tensors' device
    :param x: (N, F) or (B, N, F) float features (one matrix per fold)
    :param y: (N,) integer class ids in [0, n_classes)
    :param sample_weight: (N,) or (B, N) weights, 0 = ignore; integer
        values keep the fit deterministic
    :returns: :class:`ForestParams` with a leading (B,) axis when ``x`` or
        ``sample_weight`` has one
    """
    batched = x.ndim == 3 or sample_weight.ndim == 2
    dev = x.device
    x = x.to(torch.float32)
    sw = sample_weight.to(torch.float32)
    n_folds = max(x.shape[0] if x.ndim == 3 else 1,
                  sw.shape[0] if sw.ndim == 2 else 1)
    x = x.expand(n_folds, *x.shape[-2:]) if x.ndim == 3 else \
        x.expand(n_folds, *x.shape)
    sw = sw.expand(n_folds, sw.shape[-1])
    _, n, f = x.shape
    t = n_trees
    g = n_folds * t                                        # trees in all
    onehot = F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)

    if bootstrap:
        boot = torch.poisson(torch.ones((n_folds, t, n), device=dev),
                             generator=generator)
    else:
        boot = torch.ones((n_folds, t, n), device=dev)
    w_flat = (boot * sw[:, None, :]).reshape(g * n)       # (G*N,)
    x_flat = x.reshape(n_folds * n, f)
    tree = torch.arange(g, device=dev)
    # row of x_flat of each (tree, sample)
    row = ((tree // t)[:, None] * n
           + torch.arange(n, device=dev)[None, :]).reshape(-1)
    oh_tiled = onehot.repeat(g, 1)                         # (G*N, C)
    wpos = w_flat > 0

    node = torch.zeros((g, n), dtype=torch.int64, device=dev)
    n_internal = 2 ** depth - 1
    feat_store = torch.zeros((g, n_internal), dtype=torch.int64, device=dev)
    thr_store = torch.zeros((g, n_internal), dtype=torch.float32, device=dev)
    for d in range(depth):
        level_nodes, level_off = 2 ** d, 2 ** d - 1
        seg_id = (tree[:, None] * level_nodes + node - level_off).reshape(-1)
        n_seg = g * level_nodes
        cand_feat = torch.randint(0, f, (n_seg, n_candidates),
                                  generator=generator, device=dev)
        cand_u = torch.rand((n_seg, n_candidates), generator=generator,
                            device=dev)
        tot_cnt = _seg_sum(w_flat, seg_id, n_seg).to(torch.float32)
        tot_cls = _seg_sum(w_flat[:, None] * oh_tiled, seg_id,
                           n_seg).to(torch.float32)
        best_gini = torch.full((n_seg,), float('inf'), device=dev)
        best_feat = torch.zeros((n_seg,), dtype=torch.int64, device=dev)
        best_thr = torch.zeros((n_seg,), device=dev)
        for c in range(n_candidates):
            fc = cand_feat[:, c]
            fv = x_flat[row, fc[seg_id]]                   # (G*N,)
            lo = torch.full((n_seg,), _BIG, device=dev).scatter_reduce_(
                0, seg_id, torch.where(wpos, fv, _BIG), 'amin')
            hi = torch.full((n_seg,), -_BIG, device=dev).scatter_reduce_(
                0, seg_id, torch.where(wpos, fv, -_BIG), 'amax')
            thr = lo + cand_u[:, c] * (hi - lo)
            go_left = (fv < thr[seg_id]).to(torch.float32) * w_flat
            lcls = _seg_sum(go_left[:, None] * oh_tiled, seg_id,
                            n_seg).to(torch.float32)
            lcnt = torch.sum(lcls, dim=1)
            rcls, rcnt = tot_cls - lcls, tot_cnt - lcnt
            score = (lcnt * _gini(lcls, lcnt) + rcnt * _gini(rcls, rcnt)) \
                / torch.clamp_min(tot_cnt, 1e-10)
            score = torch.where((lcnt < 1e-6) | (rcnt < 1e-6), float('inf'),
                                score)
            take = score < best_gini
            best_gini = torch.where(take, score, best_gini)
            best_feat = torch.where(take, fc, best_feat)
            best_thr = torch.where(take, thr, best_thr)
        # an unsplittable node routes everything right
        best_thr = torch.where(torch.isfinite(best_gini), best_thr, -_BIG)
        feat_store[:, level_off:level_off + level_nodes] = \
            best_feat.reshape(g, level_nodes)
        thr_store[:, level_off:level_off + level_nodes] = \
            best_thr.reshape(g, level_nodes)
        fv = x_flat[row, best_feat[seg_id]]
        left = (fv < best_thr[seg_id]).reshape(g, n)
        node = 2 * node + torch.where(left, 1, 2)

    n_leaves = 2 ** depth
    leaf_id = (tree[:, None] * n_leaves + node - n_internal).reshape(-1)
    leaf_cls = _seg_sum(w_flat[:, None] * oh_tiled, leaf_id, g * n_leaves)
    # an empty leaf falls back to its fold's weighted class prior
    prior = sw.to(torch.float64) @ onehot.to(torch.float64)     # (B, C)
    prior = prior / torch.clamp_min(prior.sum(dim=1, keepdim=True), 1e-10)
    prior = prior.repeat_interleave(t * n_leaves, dim=0)
    cnt = leaf_cls.sum(dim=1, keepdim=True)
    proba = torch.where(cnt > 0, leaf_cls / torch.clamp_min(cnt, 1e-10),
                        prior).to(torch.float32)
    shape = (n_folds, t) if batched else (t,)
    return ForestParams(feat_store.reshape(shape + (n_internal,)),
                        thr_store.reshape(shape + (n_internal,)),
                        proba.reshape(shape + (n_leaves, n_classes)), depth)


def _forest_predict(feat, thr_store, leaf_proba, depth, x, reduce_mean=True):
    """Walk every tree in lockstep.

    :param feat: (T, n_internal) or (B, T, n_internal)
    :param x: (N, F), or (B, N, F) with batched parameters
    :returns: (N, C) (or (B, N, C)) mean leaf distributions, or the (T, N,
        C) per-tree ones without ``reduce_mean``
    """
    batched = feat.ndim == 3
    if not batched:
        feat, thr_store, leaf_proba = feat[None], thr_store[None], \
            leaf_proba[None]
        x = x[None]
    x = x.to(torch.float32)
    b, t = feat.shape[:2]
    n, f = x.shape[-2:]
    x = x.expand(b, n, f)
    x_flat = x.reshape(-1)
    base = (torch.arange(b, device=x.device)[:, None, None] * n
            + torch.arange(n, device=x.device)[None, None, :]) * f
    node = torch.zeros((b, t, n), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        fidx = torch.take_along_dim(feat, node, dim=2)
        thr = torch.take_along_dim(thr_store, node, dim=2)
        fv = x_flat[base + fidx]
        node = 2 * node + torch.where(fv < thr, 1, 2)
    leaf = node - (2 ** depth - 1)
    probs = torch.take_along_dim(leaf_proba, leaf[..., None], dim=2)
    out = torch.mean(probs, dim=1) if reduce_mean else probs
    return out if batched else out[0]


def forest_predict_proba(params: ForestParams, x):
    """(N, C) averaged leaf distributions."""
    return _forest_predict(params.feat, params.thr, params.leaf_proba,
                           int(params.depth), x)
