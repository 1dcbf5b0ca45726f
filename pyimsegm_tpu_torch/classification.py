"""Supervised classification: the classifier family, CV iterators,
dataset balancing, the hyper-parameter search, persistence and the host
helpers of the supervised app (port of ``pyimsegm_tpu.classification``).

=============  =====================================================
name           implementation
=============  =====================================================
RandForest     level-synchronous random forest (default)
GradBoost      histogram gradient-boosted trees (``models/gbt``)
DecTree        single deep tree (forest with n_trees=1)
AdaBoost       SAMME.R boosting over reweighted trees (``models/adaboost``)
LogistRegr     multinomial logistic regression (full-batch Adam)
SVM            one-vs-rest squared-hinge linear SVM, softmax-calibrated
KNN            brute-force kNN by a distance matmul
MLP            one-hidden-layer network
=============  =====================================================

The classifier's scaler and PCA are fitted on the host in numpy, as the
reference fits them; the model is fitted and applied on the classifier's
device (``'cuda'`` unless the caller asks for ``'cpu'``).  The CV folds and
the search candidates are drawn from numpy and equal the reference's.
:func:`classifier_from_numpy` carries a classifier fitted by the JAX
package across.  The helpers that return a DataFrame import pandas when
they are called; nothing else needs it.
"""

import itertools
import logging
import os
import pickle

import numpy as np
import torch

from pyimsegm_tpu_torch.models import adaboost as adaboost_mod
from pyimsegm_tpu_torch.models import forest as forest_mod
from pyimsegm_tpu_torch.models import gbt as gbt_mod
from pyimsegm_tpu_torch.models import linear as linear_mod
from pyimsegm_tpu_torch.utils.device import as_tensor
from pyimsegm_tpu_torch.utils.metrics import compute_classif_metrics

#: default classifier
DEFAULT_CLASSIF_NAME = 'RandForest'
#: default clustering of the unsupervised pipelines
DEFAULT_CLUSTERING = 'GMM'
#: file name pattern of saved classifiers
TEMPLATE_NAME_CLF = 'classifier_{}.pkl'
#: every classifier name
CLASSIFIER_NAMES = ('RandForest', 'GradBoost', 'LogistRegr', 'KNN', 'SVM',
                    'DecTree', 'AdaBoost', 'MLP')
#: classifiers whose CV folds are fitted in one batched fit
_FOLD_BATCHED_CLFS = ('RandForest', 'DecTree', 'GradBoost', 'LogistRegr',
                      'SVM', 'MLP')
#: the clip of AdaBoost's tree probabilities in the segmentation pipelines
#: (the reference's ``device_predict_fn``); ``predict_proba`` clips at
#: ``models.adaboost._EPS``
PIPELINE_ADABOOST_EPS = 1e-10

#: randomised hyper-parameter distributions
CLF_PARAM_DISTRIBUTIONS = {
    'RandForest': {'n_trees': [16, 32, 64], 'depth': [6, 8, 10],
                   'n_candidates': [4, 8, 16]},
    'GradBoost': {'n_rounds': [32, 64, 96], 'depth': [3, 4, 5],
                  'learning_rate': [0.05, 0.1, 0.2]},
    'DecTree': {'depth': [8, 12, 16]},
    'AdaBoost': {'n_rounds': [12, 24, 48], 'depth': [2, 3, 4]},
    'LogistRegr': {'l2': [1e-5, 1e-4, 1e-3, 1e-2], 'steps': [200, 400]},
    'SVM': {'C': [0.1, 1.0, 10.0]},
    'KNN': {'k': [3, 5, 9, 15]},
    'MLP': {'hidden': [32, 64, 128], 'steps': [300, 600]},
}


def _check_name(name):
    if name not in CLASSIFIER_NAMES:
        raise ValueError('unknown classifier: %r' % name)


def _forest_kwargs(name, hyper):
    """forest_fit keywords of a forest name and its hyper-parameters."""
    if name == 'DecTree':
        return dict(n_trees=1, depth=hyper.get('depth', 12),
                    n_candidates=hyper.get('n_candidates', 32),
                    bootstrap=False)
    return dict(n_trees=hyper.get('n_trees', 32), depth=hyper.get('depth', 8),
                n_candidates=hyper.get('n_candidates', 8))


def _fit_params(name, hyper, gen, x, y, w, n_classes):
    """The fitted parameters of classifier ``name`` (per-name defaults of
    the reference); ``x`` and ``w`` may carry a leading fold axis for the
    fold-batched families."""
    h = hyper
    if name in ('RandForest', 'DecTree'):
        return forest_mod.forest_fit(gen, x, y, w, n_classes,
                                     **_forest_kwargs(name, h))
    if name == 'GradBoost':
        return gbt_mod.gbt_fit(x, y, w, n_classes,
                               n_rounds=h.get('n_rounds', 64),
                               depth=h.get('depth', 4),
                               learning_rate=h.get('learning_rate', 0.1),
                               n_bins=h.get('n_bins', 64))
    if name == 'AdaBoost':
        return adaboost_mod.adaboost_fit(gen, x, y, w, n_classes,
                                         n_rounds=h.get('n_rounds', 24),
                                         depth=h.get('depth', 3),
                                         n_candidates=h.get('n_candidates',
                                                            16))
    if name == 'LogistRegr':
        return linear_mod.logistic_fit(x, y, w, n_classes,
                                       l2=h.get('l2', 1e-4),
                                       steps=h.get('steps', 300))
    if name == 'SVM':
        return linear_mod.linear_svm_fit(x, y, w, n_classes,
                                         c_reg=h.get('C', 1.0),
                                         steps=h.get('steps', 400))
    if name == 'MLP':
        return linear_mod.mlp_fit(gen, x, y, w, n_classes,
                                  hidden=h.get('hidden', 64),
                                  steps=h.get('steps', 500))
    if name == 'KNN':
        return linear_mod.knn_fit(x, y, w, n_classes, k=h.get('k', 5))
    raise ValueError('unknown classifier: %r' % name)


def _predict_params(name, params, x, adaboost_eps=adaboost_mod._EPS):
    """(N, C) probabilities of fitted ``params`` on scaled features (a
    leading fold axis where the parameters have one)."""
    if name in ('RandForest', 'DecTree'):
        return forest_mod._forest_predict(params.feat, params.thr,
                                          params.leaf_proba,
                                          int(params.depth), x)
    if name == 'GradBoost':
        return torch.softmax(gbt_mod._gbt_raw_scores(
            params.feat, params.thr, params.leaf, params.base_score,
            params.learning_rate, int(params.depth), x), dim=-1)
    if name == 'AdaBoost':
        return adaboost_mod.adaboost_scores_proba(
            params.feat, params.thr, params.leaf_proba, int(params.depth), x,
            eps=adaboost_eps)
    if name in ('LogistRegr', 'SVM'):
        return linear_mod.logistic_predict_proba(params, x)
    if name == 'MLP':
        return linear_mod.mlp_predict_proba(params, x)
    return linear_mod.knn_predict_proba(params, x)


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Classifier:
    """Scaler + optional PCA + one of :data:`CLASSIFIER_NAMES`, with
    ``fit`` / ``predict`` / ``predict_proba`` / ``classes_``.

    :param device: where the model is fitted and applied
    """

    def __init__(self, name=DEFAULT_CLASSIF_NAME, pca_coef=None, seed=0,
                 device='cuda', **hyper):
        _check_name(name)
        self.name = name
        self.pca_coef = pca_coef
        self.seed = seed
        self.device = torch.device(device)
        self.hyper = dict(hyper)
        self.classes_ = None
        self._params = None
        self._scaler = None
        self._pca = None

    # -------------------------------------------------------------- fit ---
    def fit(self, features, labels, sample_weight=None):
        x = _numpy(features).astype(np.float32)
        y = _numpy(labels)
        self.classes_ = np.unique(y)
        y_dense = np.searchsorted(self.classes_, y).astype(np.int64)
        w = (np.ones(len(x), np.float32) if sample_weight is None
             else _numpy(sample_weight).astype(np.float32))
        mu, sd = x.mean(0), x.std(0) + 1e-12
        self._scaler = (mu, sd)
        xs = (x - mu) / sd
        if self.pca_coef is not None:
            eigval, eigvec = np.linalg.eigh(np.atleast_2d(np.cov(xs.T)))
            order = np.argsort(eigval)[::-1]
            eigval, eigvec = eigval[order], eigvec[:, order]
            ratio = np.cumsum(eigval) / max(eigval.sum(), 1e-30)
            ncomp = int(np.searchsorted(ratio, self.pca_coef) + 1)
            self._pca = eigvec[:, :ncomp]
            xs = xs @ self._pca
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(self.seed))
        self._params = _fit_params(
            self.name, self.hyper, gen, as_tensor(xs.astype(np.float32), dev),
            as_tensor(y_dense, dev), as_tensor(w, dev), len(self.classes_))
        return self

    # ---------------------------------------------------------- predict ---
    def transform(self, features):
        """Scaled (and projected) f32 features as a tensor on the
        classifier's device."""
        x = as_tensor(features, self.device).to(torch.float32)
        mu, sd = self._scaler
        x = (x - torch.as_tensor(mu, dtype=torch.float32, device=x.device)) \
            / torch.as_tensor(sd, dtype=torch.float32, device=x.device)
        if self._pca is not None:
            x = x @ torch.as_tensor(self._pca, dtype=torch.float32,
                                    device=x.device)
        return x

    def _proba(self, features, adaboost_eps):
        if self._params is None:
            raise RuntimeError('classifier is not fitted')
        proba = _predict_params(self.name, self._params,
                                self.transform(features), adaboost_eps)
        return proba if isinstance(features, torch.Tensor) else \
            proba.cpu().numpy()

    def predict_proba(self, features):
        """(N, C) class probabilities: a tensor on the classifier's device
        for a tensor input, else a numpy array."""
        return self._proba(features, adaboost_mod._EPS)

    def device_predict_proba(self, features):
        """:meth:`predict_proba` as the segmentation pipelines take it (the
        reference's ``device_predict_fn``): the same, except that AdaBoost
        clips its tree probabilities at :data:`PIPELINE_ADABOOST_EPS`."""
        return self._proba(features, PIPELINE_ADABOOST_EPS)

    def predict(self, features):
        """Class labels (from ``classes_``) as a numpy array."""
        proba = _numpy(self.predict_proba(features))
        return self.classes_[np.argmax(proba, axis=1)]

    def score(self, features, labels):
        return float(np.mean(self.predict(features) == _numpy(labels)))


def create_classifiers(**kwargs):
    """Name -> unfitted :class:`Classifier` of every name."""
    return {n: Classifier(n, **kwargs) for n in CLASSIFIER_NAMES}


#: the arrays of each family's parameters, in their NamedTuple's order, and
#: the python scalars among them
_PARAM_ARRAYS = {
    'forest': (forest_mod.ForestParams, ('feat', 'thr', 'leaf_proba'),
               ('depth',)),
    'GradBoost': (gbt_mod.GBTParams, ('feat', 'thr', 'leaf', 'base_score'),
                  ('learning_rate', 'depth')),
    'AdaBoost': (adaboost_mod.AdaBoostParams, ('feat', 'thr', 'leaf_proba'),
                 ('depth',)),
    'linear': (linear_mod.LinearParams, ('w', 'b'), ()),
    'MLP': (linear_mod.MLPParams, ('w1', 'b1', 'w2', 'b2'), ()),
    'KNN': (linear_mod.KNNParams, ('x', 'onehot', 'weight'), ('k',)),
}


def _family(name):
    return ('forest' if name in ('RandForest', 'DecTree') else
            'linear' if name in ('LogistRegr', 'SVM') else name)


def classifier_from_numpy(d, name=DEFAULT_CLASSIF_NAME, device='cuda'):
    """A fitted :class:`Classifier` from plain arrays: ``scaler_mean``,
    ``scaler_std``, optional ``pca`` (D, P), ``classes``, and the model's
    arrays under their parameter names (forests and AdaBoost ``feat``,
    ``thr``, ``leaf_proba``, ``depth``; GradBoost ``feat``, ``thr``,
    ``leaf``, ``base_score``, ``learning_rate``, ``depth``; LogistRegr and
    SVM ``w``, ``b``; MLP ``w1``, ``b1``, ``w2``, ``b2``; KNN ``x``,
    ``onehot``, ``weight``, ``k``).  This is how a classifier fitted by the
    JAX package is carried across."""
    clf = Classifier(name, device=device)
    clf.classes_ = np.asarray(d['classes'])
    clf._scaler = (np.asarray(d['scaler_mean'], np.float32),
                   np.asarray(d['scaler_std'], np.float32))
    clf._pca = None if d.get('pca') is None else np.asarray(d['pca'])
    cls, arrays, scalars = _PARAM_ARRAYS[_family(name)]
    fields = {}
    for k in arrays:
        a = np.asarray(d[k])
        fields[k] = torch.as_tensor(
            a.astype(np.int64) if a.dtype.kind in 'iu' else
            a.astype(np.float32), device=clf.device)
    for k in scalars:
        v = np.asarray(d[k])
        fields[k] = int(v) if v.dtype.kind in 'iu' else float(v)
    clf._params = cls(**fields)
    return clf


def classifier_to_numpy(clf):
    """The arrays :func:`classifier_from_numpy` reads."""
    p = clf._params
    out = {'classes': np.asarray(clf.classes_),
           'scaler_mean': np.asarray(clf._scaler[0], np.float32),
           'scaler_std': np.asarray(clf._scaler[1], np.float32)}
    _cls, arrays, scalars = _PARAM_ARRAYS[_family(clf.name)]
    for k in arrays:
        a = _numpy(getattr(p, k))
        out[k] = a.astype(np.int32) if a.dtype.kind in 'iu' else \
            a.astype(np.float32)
    for k in scalars:
        v = getattr(p, k)
        out[k] = np.asarray(v, np.int32 if isinstance(v, int) else
                            np.float64)
    if clf._pca is not None:
        out['pca'] = np.asarray(clf._pca)
    return out


# ------------------------------------------------------------ CV iterators ---

class HoldOut:
    """Single train / test split at a fixed index."""

    def __init__(self, nb_samples, hold_out, rand_seed=None):
        if hold_out >= nb_samples:
            raise ValueError('hold_out %i exceeds samples %i'
                             % (hold_out, nb_samples))
        self.total = nb_samples
        self.hold_out = hold_out
        self._indexes = list(range(nb_samples))
        if rand_seed is not None and rand_seed is not False:
            np.random.default_rng(rand_seed).shuffle(self._indexes)

    def __iter__(self):
        yield (self._indexes[:self.hold_out], self._indexes[self.hold_out:])

    def __len__(self):
        return 1


class CrossValidate:
    """K-fold CV over samples, ``nb_hold_out`` samples per test fold."""

    def __init__(self, nb_samples, nb_hold_out, rand_seed=None):
        if nb_hold_out > nb_samples:
            raise ValueError('nb_hold_out %i exceeds samples %i'
                             % (nb_hold_out, nb_samples))
        self.nb_samples = nb_samples
        self.nb_hold_out = nb_hold_out
        self._indexes = list(range(nb_samples))
        if rand_seed is not None and rand_seed is not False:
            np.random.default_rng(rand_seed).shuffle(self._indexes)

    def __iter__(self):
        for start in range(0, self.nb_samples, self.nb_hold_out):
            test = self._indexes[start:start + self.nb_hold_out]
            held = set(test)
            yield [i for i in self._indexes if i not in held], test

    def __len__(self):
        return int(np.ceil(self.nb_samples / float(self.nb_hold_out)))


class CrossValidateGroups:
    """Leave-P-groups-out CV over samples that come in per-image blocks of
    the given sizes."""

    def __init__(self, set_sizes, nb_hold_out, rand_seed=None):
        if nb_hold_out > len(set_sizes):
            raise ValueError('nb_hold_out %i exceeds groups %i'
                             % (nb_hold_out, len(set_sizes)))
        self.set_sizes = list(set_sizes)
        self.nb_hold_out = nb_hold_out
        offsets = np.cumsum([0] + self.set_sizes)
        self._group_idx = [list(range(offsets[i], offsets[i + 1]))
                           for i in range(len(self.set_sizes))]
        self._order = list(range(len(self.set_sizes)))
        if rand_seed is not None and rand_seed is not False:
            np.random.default_rng(rand_seed).shuffle(self._order)

    def __iter__(self):
        for start in range(0, len(self._order), self.nb_hold_out):
            test_groups = self._order[start:start + self.nb_hold_out]
            held = set(test_groups)
            test = [i for g in test_groups for i in self._group_idx[g]]
            train = [i for g in self._order if g not in held
                     for i in self._group_idx[g]]
            yield train, test

    def __len__(self):
        return int(np.ceil(len(self.set_sizes) / float(self.nb_hold_out)))


# ------------------------------------------------------------- balancing ---

def down_sample_dict_features_random(dict_features, nb_samples, rand_seed=0):
    """Random down-sampling to ``nb_samples`` per label."""
    out = {}
    rng = np.random.default_rng(rand_seed)
    for lb, fts in dict_features.items():
        fts = np.asarray(fts)
        out[lb] = fts if len(fts) <= nb_samples else \
            fts[rng.choice(len(fts), nb_samples, replace=False)]
    return out


def down_sample_dict_features_unique(dict_features):
    """The unique feature rows per label."""
    return {lb: np.unique(np.asarray(fts), axis=0)
            for lb, fts in dict_features.items()}


def down_sample_dict_features_kmean(dict_features, nb_samples, rand_seed=0,
                                    device='cuda'):
    """``nb_samples`` k-means centroids per label as its representatives
    (the port's k-means, on ``device``)."""
    from pyimsegm_tpu_torch.models.gmm import kmeans_fit
    out = {}
    for lb, fts in dict_features.items():
        fts = np.asarray(fts, np.float32)
        if len(fts) <= nb_samples:
            out[lb] = fts
            continue
        x = as_tensor(fts, device)
        gen = torch.Generator(device=x.device).manual_seed(int(rand_seed))
        centers, _ = kmeans_fit(gen, x, torch.ones(len(fts), device=x.device),
                                nb_samples, n_iter=15)
        out[lb] = centers.cpu().numpy()
    return out


def balance_dataset_by_(features, labels, balance_type='unique',
                        min_samples=None, rand_seed=0, device='cuda'):
    """Balance the per-label sample counts ('unique', 'random' or
    'kmeans')."""
    labels = np.asarray(labels)
    dict_features = {lb: np.asarray(features)[labels == lb]
                     for lb in np.unique(labels)}
    if balance_type == 'unique':
        dict_features = down_sample_dict_features_unique(dict_features)
    else:
        if min_samples is None:
            min_samples = min(len(v) for v in dict_features.values())
        if balance_type == 'random':
            dict_features = down_sample_dict_features_random(
                dict_features, min_samples, rand_seed)
        elif balance_type == 'kmeans':
            dict_features = down_sample_dict_features_kmean(
                dict_features, min_samples, rand_seed, device=device)
        else:
            raise ValueError('unknown balance_type: %r' % balance_type)
    fts = np.concatenate([dict_features[lb] for lb in sorted(dict_features)])
    lbs = np.concatenate([[lb] * len(dict_features[lb])
                          for lb in sorted(dict_features)])
    return fts, lbs


def convert_set_features_labels_2_dataset(dict_features, dict_labels,
                                          drop_labels=None, balance_type=None,
                                          device='cuda'):
    """Per-image features and labels as one dataset (a 'kmeans' balance
    runs on ``device``).

    :returns: (features, labels, sizes), sizes the per-image counts kept
        (for group CV)
    """
    drop = list(drop_labels or [])
    list_fts, list_lbs, sizes = [], [], []
    for key in dict_features:
        fts = np.asarray(dict_features[key])
        lbs = np.asarray(dict_labels[key])
        keep = ~np.isin(lbs, drop)
        fts, lbs = fts[keep], lbs[keep]
        if balance_type and balance_type != 'none':
            fts, lbs = balance_dataset_by_(fts, lbs, balance_type=balance_type,
                                           device=device)
        list_fts.append(fts)
        list_lbs.append(lbs)
        sizes.append(len(lbs))
    return np.concatenate(list_fts), np.concatenate(list_lbs), sizes


# ----------------------------------------------------- search/train/export ---

def _fold_mats(features, labels, folds):
    """(x, class-indexed y, n_classes, per-fold train-weight matrix): fold
    membership is 0/1 sample weights, so every fold has the same shapes."""
    x = np.asarray(features, np.float32)
    classes = np.unique(labels)
    y = np.searchsorted(classes, labels).astype(np.int32)
    w_tr = np.zeros((len(folds), x.shape[0]), np.float32)
    for i, (train_idx, _test) in enumerate(folds):
        w_tr[i, np.asarray(train_idx, int)] = 1.0
    return x, y, len(classes), w_tr


def _fold_accuracies(clf_name, hyper, x, y, n_classes, w_tr, seed, device):
    """(B,) test accuracy of every fold, all folds fitted and scored in one
    batched fit: fold b is standardised over its own training rows and
    trained on them (weight 1), and scored on the rest."""
    xd, yd = as_tensor(x, device), as_tensor(y, device).to(torch.int64)
    w = as_tensor(w_tr, device)
    wsum = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
    mu = (w @ xd / wsum)[:, None, :]                         # (B, 1, F)
    sd = torch.sqrt(torch.sum(((xd[None] - mu) ** 2) * w[..., None], dim=1,
                              keepdim=True) / wsum[..., None]) + 1e-12
    xs = (xd[None] - mu) / sd                                # (B, N, F)
    gen = torch.Generator(device=xd.device).manual_seed(int(seed))
    params = _fit_params(clf_name, hyper, gen, xs, yd, w, n_classes)
    pred = torch.argmax(_predict_params(clf_name, params, xs), dim=-1)
    test_w = 1.0 - w
    hits = torch.sum((pred == yd[None]).to(torch.float32) * test_w, dim=1)
    return hits / torch.clamp_min(torch.sum(test_w, dim=1), 1.0)


def _eval_cv_scores_fold_batched(clf_name, features, labels, folds, seed,
                                 hyper, device='cuda'):
    """Accuracy per CV fold, all folds in one batched fit."""
    x, y, n_classes, w_tr = _fold_mats(features, labels, folds)
    accs = _fold_accuracies(clf_name, hyper, x, y, n_classes, w_tr, seed,
                            device)
    return [float(a) for a in accs.cpu().numpy()]


def _eval_cv_search_batched(clf_name, features, labels, folds, seed,
                            candidates, device='cuda'):
    """Mean CV accuracy of every hyper-parameter candidate: one batched
    fit over the folds per candidate.

    :returns: (n_candidates,) float64, candidate order kept
    """
    x, y, n_classes, w_tr = _fold_mats(features, labels, folds)
    scores = np.zeros(len(candidates), np.float64)
    for ci, hyper in enumerate(candidates):
        accs = _fold_accuracies(clf_name, hyper, x, y, n_classes, w_tr, seed,
                                device)
        scores[ci] = float(torch.mean(accs))
    return scores


def _cross_val(cross_val, n, seed):
    if isinstance(cross_val, int):
        return CrossValidate(n, max(1, n // cross_val), rand_seed=seed)
    return cross_val


def eval_classif_cross_val_scores(clf_name, features, labels, cross_val=10,
                                  pca_coef=None, seed=0, device='cuda',
                                  **hyper):
    """Accuracy per CV fold: one batched fit for the fold-batched families
    without PCA, else a host loop of fits."""
    _check_name(clf_name)
    features = np.asarray(features)
    labels = np.asarray(labels)
    folds = list(_cross_val(cross_val, len(labels), seed))
    if pca_coef is None and clf_name in _FOLD_BATCHED_CLFS:
        return _eval_cv_scores_fold_batched(clf_name, features, labels, folds,
                                            seed, hyper, device)
    scores = []
    for train_idx, test_idx in folds:
        clf = Classifier(clf_name, pca_coef=pca_coef, seed=seed,
                         device=device, **hyper)
        clf.fit(features[train_idx], labels[train_idx])
        scores.append(clf.score(features[test_idx], labels[test_idx]))
    return scores


def create_classif_search_train_export(clf_name, features, labels,
                                       cross_val=10, nb_search_iter=1,
                                       pca_coef=None, seed=0, path_out=None,
                                       device='cuda', **_ignored):
    """Random hyper-parameter search by CV accuracy, the final fit on all
    samples, and an optional pickle export.

    :returns: (fitted Classifier, best hyper-parameters dict)
    """
    _check_name(clf_name)
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    space = CLF_PARAM_DISTRIBUTIONS.get(clf_name, {})
    candidates = [{}]
    for _ in range(max(0, nb_search_iter - 1)):
        candidates.append({k: v[rng.integers(len(v))]
                           for k, v in space.items()})
    best_hyper = {}
    if len(candidates) > 1:
        if pca_coef is None and clf_name in _FOLD_BATCHED_CLFS:
            folds = list(_cross_val(cross_val, len(labels), seed))
            scores = _eval_cv_search_batched(clf_name, features, labels,
                                             folds, seed, candidates, device)
        else:
            scores = [float(np.mean(eval_classif_cross_val_scores(
                clf_name, features, labels, cross_val=cross_val,
                pca_coef=pca_coef, seed=seed, device=device, **hyper)))
                for hyper in candidates]
        for hyper, score in zip(candidates, scores):
            logging.debug('search %s %r -> %.4f', clf_name, hyper, score)
        best_hyper = candidates[int(np.argmax(scores))]
    classif = Classifier(clf_name, pca_coef=pca_coef, seed=seed, device=device,
                         **best_hyper)
    classif.fit(features, labels)
    if path_out:
        save_classifier(path_out, classif, clf_name)
    return classif, best_hyper


# ------------------------------------------------------------- persistence ---

def save_classifier(path_out, classif, clf_name='classif'):
    """Pickle a fitted classifier as numpy arrays; returns the path."""
    path = os.path.join(path_out, TEMPLATE_NAME_CLF.format(clf_name))
    state = {'name': classif.name, 'pca_coef': classif.pca_coef,
             'seed': classif.seed, 'hyper': classif.hyper,
             'arrays': classifier_to_numpy(classif)}
    with open(path, 'wb') as fp:
        pickle.dump(state, fp)
    return path


def load_classifier(path, device='cuda'):
    """Load a classifier saved by :func:`save_classifier` onto ``device``."""
    with open(path, 'rb') as fp:
        state = pickle.load(fp)
    clf = classifier_from_numpy(state['arrays'], state['name'], device=device)
    clf.pca_coef = state['pca_coef']
    clf.seed = state['seed']
    clf.hyper = state['hyper']
    return clf


# ----------------------------------------------- metrics of segmentations ---

def compute_tp_tn_fp_fn(annot, segm, label_positive=None):
    """Binary TP / TN / FP / FN counts; NaNs when more than two labels
    appear.

    >>> annot = np.array([[0, 9], [9, 0]])
    >>> compute_tp_tn_fp_fn(annot, annot)
    (2, 2, 0, 0)
    """
    y_true = np.asarray(annot).ravel()
    y_pred = np.asarray(segm).ravel()
    uq_labels = np.unique([y_true, y_pred]).tolist()
    if len(uq_labels) > 2:
        return np.nan, np.nan, np.nan, np.nan
    if len(uq_labels) < 2:
        return len(y_true), 0, 0, 0
    if label_positive is None or label_positive not in uq_labels:
        label_positive = uq_labels[-1]
    uq_labels.remove(label_positive)
    label_negative = uq_labels[0]
    tp = int(np.sum((y_true == label_positive) & (y_pred == label_positive)))
    tn = int(np.sum((y_true == label_negative) & (y_pred == label_negative)))
    fp = int(np.sum((y_true == label_positive) & (y_pred == label_negative)))
    fn = int(np.sum((y_true == label_negative) & (y_pred == label_positive)))
    return tp, tn, fp, fn


def _nan_count(tp):
    return tp is np.nan or (isinstance(tp, float) and np.isnan(tp))


def compute_metric_fpfn_tpfn(annot, segm, label_positive=None):
    """(FP + FN) / (TP + FN)."""
    tp, _, fp, fn = compute_tp_tn_fp_fn(annot, segm, label_positive)
    if _nan_count(tp):
        return np.nan
    if (fp + fn) == 0:
        return 0.
    return float(fp + fn) / float(tp + fn)


def compute_metric_tpfp_tpfn(annot, segm, label_positive=None):
    """(TP + FP) / (TP + FN)."""
    tp, _, fp, fn = compute_tp_tn_fp_fn(annot, segm, label_positive)
    if _nan_count(tp):
        return np.nan
    if (tp + fn) == 0:
        return 0.
    return float(tp + fp) / float(tp + fn)


def compute_classif_stat_segm_annot(annot_segm_name, drop_labels=None,
                                    relabel=False):
    """The metric row of one (annot, segm, name) triple."""
    annot, segm, name = annot_segm_name
    annot = np.asarray(annot).ravel()
    segm = np.asarray(segm).ravel()
    if drop_labels is not None:
        keep = ~np.isin(annot, list(drop_labels))
        annot, segm = annot[keep], segm[keep]
    if relabel:
        from pyimsegm_tpu_torch.labeling import relabel_max_overlap_unique
        segm = relabel_max_overlap_unique(annot[None, :], segm[None, :],
                                          keep_bg=False).ravel()
    stat = compute_classif_metrics(annot, segm)
    stat['name'] = name
    return stat


def compute_stat_per_image(segms, annots, names=None, nb_workers=2,
                           drop_labels=None, relabel=False):
    """Metric table over image pairs: a DataFrame indexed by name."""
    import pandas as pd
    if len(segms) != len(annots):
        raise RuntimeError('size of segment. (%i) and annot. (%i) should be'
                           ' equal' % (len(segms), len(annots)))
    if not names:
        names = list(map(str, range(len(segms))))
    rows = [compute_classif_stat_segm_annot((a, s, n), drop_labels, relabel)
            for a, s, n in zip(annots, segms, names)]
    return pd.DataFrame(rows).set_index('name')


# ------------------------------------------------------ feature scoring ---

def _f_classif_scores(features, labels):
    """One-way ANOVA F statistic per feature."""
    features = np.asarray(features, float)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    n, _ = features.shape
    overall_mean = features.mean(axis=0)
    ss_between = np.zeros(features.shape[1])
    ss_within = np.zeros(features.shape[1])
    for c in classes:
        grp = features[labels == c]
        ss_between += len(grp) * (grp.mean(axis=0) - overall_mean) ** 2
        ss_within += ((grp - grp.mean(axis=0)) ** 2).sum(axis=0)
    df_between = len(classes) - 1
    df_within = n - len(classes)
    with np.errstate(divide='ignore', invalid='ignore'):
        f = (ss_between / max(df_between, 1)) / \
            np.maximum(ss_within / max(df_within, 1), 1e-30)
    return f


def feature_scoring_selection(features, labels, names=None, path_out='',
                              device='cuda'):
    """Rank the features by the permutation importance of a forest fitted on
    ``device`` (the accuracy drop when one feature is shuffled), with the
    F-test, k-Best and variance columns beside it.

    :returns: (indices by importance, descending; DataFrame)
    """
    import pandas as pd
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    clf = Classifier('RandForest', seed=0, device=device)
    clf.fit(features, labels)
    rng = np.random.default_rng(0)
    base_acc = clf.score(features, labels)
    importance = np.zeros(features.shape[1])
    for i in range(features.shape[1]):
        shuffled = features.copy()
        shuffled[:, i] = rng.permutation(shuffled[:, i])
        importance[i] = max(base_acc - clf.score(shuffled, labels), 0.0)
    importance /= max(importance.sum(), 1e-12)
    f_test = _f_classif_scores(features, labels)
    scores = {'ExtTree': importance, 'F-test': f_test, 'k-Best': f_test,
              'variance': features.var(axis=0)}
    indices = np.argsort(importance)[::-1]
    if names is None or len(names) < features.shape[1]:
        names = [str(i) for i in range(1, features.shape[1] + 1)]
    df_scoring = pd.DataFrame(
        [{**{k: scores[k][i] for k in scores}, 'feature': n}
         for i, n in enumerate(names)]).set_index('feature')
    if path_out and os.path.exists(path_out):
        df_scoring.to_csv(os.path.join(path_out, 'feature_scoring.csv'))
    return indices, df_scoring


def eval_classif_cross_val_roc(clf_name, features, labels, cross_val=10,
                               nb_steps=100, seed=0, device='cuda', **hyper):
    """The mean one-vs-rest micro ROC over the CV folds and its mean AUC.

    :returns: (DataFrame with FP / TP columns, mean AUC)
    """
    import pandas as pd
    features = np.asarray(features)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    fp_space = np.linspace(0, 1, nb_steps)
    tps, aucs = [], []
    for train_idx, test_idx in _cross_val(cross_val, len(labels), seed):
        clf = Classifier(clf_name, seed=seed, device=device, **hyper)
        clf.fit(features[train_idx], labels[train_idx])
        proba = clf.predict_proba(features[test_idx])
        y = labels[test_idx]
        onehot = (y[:, None] == classes[None, :]).astype(float)
        order = np.argsort(-proba.ravel())
        truth = onehot.ravel()[order]
        tp_cum = np.cumsum(truth) / max(truth.sum(), 1.0)
        fp_cum = np.cumsum(1 - truth) / max((1 - truth).sum(), 1.0)
        tps.append(np.interp(fp_space, np.concatenate([[0], fp_cum]),
                             np.concatenate([[0], tp_cum])))
        aucs.append(float(np.trapezoid(tps[-1], fp_space)))
    mean_tp = np.mean(tps, axis=0)
    mean_tp[0] = 0.0
    return pd.DataFrame({'FP': fp_space, 'TP': mean_tp}), float(np.mean(aucs))


# ------------------------------------------------------- search objects ---

def create_clf_pipeline(name_classif=DEFAULT_CLASSIF_NAME, pca_coef=0.95,
                        device='cuda'):
    """Scaler + PCA + classifier: the :class:`Classifier` holds all three."""
    return Classifier(name_classif, pca_coef=pca_coef, device=device)


def create_pipeline_neuron_net(device='cuda'):
    """The neural-network pipeline: an MLP :class:`Classifier`."""
    return Classifier('MLP', device=device)


def create_clf_param_search_grid(name_classif=DEFAULT_CLASSIF_NAME):
    """Exhaustive hyper-parameter grid keyed ``classif__<param>``.

    >>> sorted(create_clf_param_search_grid('KNN'))
    ['classif__k']
    """
    space = CLF_PARAM_DISTRIBUTIONS.get(name_classif, {})
    return {'classif__%s' % k: list(v) for k, v in space.items()}


def create_clf_param_search_distrib(name_classif=DEFAULT_CLASSIF_NAME):
    """Randomised-search distributions: the grid's lists, sampled
    uniformly."""
    return create_clf_param_search_grid(name_classif)


def search_params_cut_down_max_nb_iter(clf_parameters, nb_iter):
    """Bound the random-search iterations by the size of the grid.

    >>> search_params_cut_down_max_nb_iter({'a': [1, 2], 'b': [1, 2, 3]}, 100)
    6
    >>> search_params_cut_down_max_nb_iter({'a': [1, 2]}, 1)
    1
    """
    total = 1
    for vals in clf_parameters.values():
        try:
            total *= len(vals)
        except TypeError:   # a continuous distribution: unbounded
            return nb_iter
    return min(total, nb_iter)


class ClassifSearch:
    """Randomised or grid hyper-parameter search by CV accuracy.  After
    :meth:`fit`: ``best_estimator_``, ``best_params_``, ``best_score_``,
    ``cv_results_``."""

    def __init__(self, clf_name, params=None, search_type='random',
                 cross_val=10, nb_iter=10, pca_coef=None, seed=0,
                 device='cuda'):
        self.clf_name = clf_name
        grid = params if params is not None \
            else create_clf_param_search_grid(clf_name)
        self.params = {k.split('__', 1)[-1]: list(v) for k, v in grid.items()}
        self.search_type = search_type
        self.cross_val = cross_val
        self.nb_iter = search_params_cut_down_max_nb_iter(self.params, nb_iter)
        self.pca_coef = pca_coef
        self.seed = seed
        self.device = device
        self.best_estimator_ = None
        self.best_params_ = None
        self.best_score_ = None
        self.cv_results_ = None

    def _candidates(self):
        keys = sorted(self.params)
        if self.search_type == 'grid':
            for combo in itertools.product(*(self.params[k] for k in keys)):
                yield dict(zip(keys, combo))
            return
        rng = np.random.default_rng(self.seed)
        seen = set()
        for _ in range(self.nb_iter * 5):
            if len(seen) >= self.nb_iter:
                return
            cand = {k: self.params[k][rng.integers(len(self.params[k]))]
                    for k in keys}
            sig = tuple(sorted(cand.items()))
            if sig not in seen:
                seen.add(sig)
                yield cand

    def fit(self, features, labels):
        features = np.asarray(features, np.float32)
        labels = np.asarray(labels)
        results = {'params': [], 'mean_test_score': []}
        best_score, best_params = -np.inf, {}
        for cand in self._candidates():
            score = float(np.mean(eval_classif_cross_val_scores(
                self.clf_name, features, labels, cross_val=self.cross_val,
                pca_coef=self.pca_coef, seed=self.seed, device=self.device,
                **cand)))
            results['params'].append(cand)
            results['mean_test_score'].append(score)
            if score > best_score:
                best_score, best_params = score, cand
        self.cv_results_ = results
        self.best_params_, self.best_score_ = best_params, best_score
        self.best_estimator_ = Classifier(
            self.clf_name, pca_coef=self.pca_coef, seed=self.seed,
            device=self.device, **best_params).fit(features, labels)
        return self


def create_classif_search(name_clf, clf_pipeline=None, nb_labels=2,
                          search_type='random', cross_val=10,
                          eval_metric='f1', nb_iter=10, nb_workers=1,
                          device='cuda'):
    """An unfitted :class:`ClassifSearch`."""
    params = (create_clf_param_search_grid(name_clf)
              if search_type == 'grid'
              else create_clf_param_search_distrib(name_clf))
    return ClassifSearch(name_clf, params=params, search_type=search_type,
                         cross_val=cross_val, nb_iter=nb_iter,
                         pca_coef=getattr(clf_pipeline, 'pca_coef', None),
                         device=device)


def export_results_clf_search(path_out, clf_name, clf_search):
    """Write the search scores (CSV) and the best parameters (text) into
    ``path_out``; returns the CSV's path."""
    if not os.path.isdir(path_out):
        raise FileNotFoundError('missing folder: %s' % path_out)
    import pandas as pd
    res = clf_search.cv_results_ or {'params': [], 'mean_test_score': []}
    df = pd.DataFrame({'params': [repr(p) for p in res['params']],
                       'mean_test_score': res['mean_test_score']})
    path_csv = os.path.join(path_out, 'search_results_%s.csv' % clf_name)
    df.to_csv(path_csv)
    path_txt = os.path.join(path_out, 'search_params_best_%s.txt' % clf_name)
    with open(path_txt, 'w') as fp:
        fp.write('score: %r\nparams: %r\n'
                 % (clf_search.best_score_, clf_search.best_params_))
    return path_csv


# ------------------------------------------------------ dataset helpers ---

def relabel_sequential(labels, uq_labels=None):
    """Relabel to a dense 0..K-1 range.

    >>> relabel_sequential([0, 0, 0, 5, 5, 5, 0, 5])
    [0, 0, 0, 1, 1, 1, 0, 1]
    """
    labels = np.asarray(labels)
    if uq_labels is None:
        uq_labels = np.unique(labels)
    lut = {lb: i for i, lb in enumerate(uq_labels)}
    return [lut[lb] for lb in labels.tolist()]


def shuffle_features_labels(features, labels, rand_seed=None):
    """Joint random permutation of the samples."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    perm = np.random.default_rng(rand_seed).permutation(len(labels))
    return features[perm], labels[perm]


def convert_dict_label_features_2_vectors(dict_features):
    """{label: feature rows} -> (features, labels)."""
    features, labels = [], []
    for lb in dict_features:
        rows = np.asarray(dict_features[lb])
        features.append(rows)
        labels += [lb] * len(rows)
    return np.concatenate(features), labels


def compose_dict_label_features(features, labels):
    """(features, labels) -> {label: feature rows}."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    return {lb: features[labels == lb] for lb in np.unique(labels)}


def unique_rows(data):
    """The distinct rows of a 2D matrix.

    >>> unique_rows(np.array([[1, 2], [1, 2], [3, 4]])).tolist()
    [[1, 2], [3, 4]]
    """
    return np.unique(np.ascontiguousarray(data), axis=0)
