"""AdaBoost (SAMME.R) over the port's trees (port of
``pyimsegm_tpu.models.adaboost``).

Each round fits one tree (``forest_fit`` with one tree, no bagging) under
the current sample weights, then reweights the samples by the SAMME.R
update ``w_i *= exp(-(C - 1) / C * y_i . log p(x_i))`` with the labels coded
``1`` for the class and ``-1 / (C - 1)`` elsewhere.  Prediction sums the
rounds' decision scores ``log p_k - mean_j log p_j`` and takes their
softmax.  Both clip the tree probabilities at ``_EPS = 1e-7`` before the
log, as the reference's ``adaboost_predict_proba`` does (its jitted
pipeline path clips at 1e-10: ``pipelines._segment_with_classif_core``).

Each round's tree draws from its own generator, split off the fit's
generator by one draw.  The round weights are fractional, so the forest's
float64 sums are exact only up to rounding: on the card their atomics may
add in another order from run to run, which moves a sum in its last bits;
a split decided by such a bit can differ between two fits.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.models import forest as forest_mod

#: the clip of the tree probabilities before the log
_EPS = 1e-7


class AdaBoostParams(NamedTuple):
    feat: torch.Tensor        # (R, n_internal) int64
    thr: torch.Tensor         # (R, n_internal) f32
    leaf_proba: torch.Tensor  # (R, n_leaves, C)
    depth: int

    @property
    def n_classes(self):
        return self.leaf_proba.shape[-1]


def _split(generator):
    """A new generator on the same device, seeded by one draw of
    ``generator``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed)


def adaboost_fit(generator, x, y, sample_weight, n_classes, n_rounds=24,
                 depth=3, n_candidates=16):
    """Fit SAMME.R AdaBoost.

    :param x: (N, F) f32; :param y: (N,) class ids
    :param sample_weight: (N,), 0 = padded slot
    :returns: :class:`AdaBoostParams`
    """
    x = x.to(torch.float32)
    w = sample_weight.to(torch.float32)
    w = w / torch.clamp_min(torch.sum(w), 1e-12)
    onehot = F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)
    y_code = torch.where(onehot > 0, 1.0, -1.0 / max(n_classes - 1, 1))
    feats, thrs, leaves = [], [], []
    for _ in range(n_rounds):
        params = forest_mod.forest_fit(_split(generator), x, y, w, n_classes,
                                       n_trees=1, depth=depth,
                                       n_candidates=n_candidates,
                                       bootstrap=False)
        proba = forest_mod.forest_predict_proba(params, x)
        logp = torch.log(torch.clamp(proba, _EPS, 1.0))
        upd = torch.exp(-(n_classes - 1.0) / n_classes
                        * torch.sum(y_code * logp, dim=1))
        w = w * upd
        w = w / torch.clamp_min(torch.sum(w), 1e-12)
        feats.append(params.feat[0])
        thrs.append(params.thr[0])
        leaves.append(params.leaf_proba[0])
    return AdaBoostParams(torch.stack(feats), torch.stack(thrs),
                          torch.stack(leaves), depth)


def adaboost_scores_proba(feat, thr, leaf_proba, depth, x, eps=_EPS):
    """(N, C) softmax of the summed SAMME.R decision scores, the tree
    probabilities clipped at ``eps``."""
    probs = forest_mod._forest_predict(feat, thr, leaf_proba, depth,
                                       x.to(torch.float32),
                                       reduce_mean=False)     # (R, N, C)
    logp = torch.log(torch.clamp(probs, eps, 1.0))
    scores = logp - torch.mean(logp, dim=-1, keepdim=True)
    return torch.softmax(torch.sum(scores, dim=0), dim=-1)


def adaboost_predict_proba(params: AdaBoostParams, x):
    """(N, C) class probabilities."""
    return adaboost_scores_proba(params.feat, params.thr, params.leaf_proba,
                                 int(params.depth), x)
