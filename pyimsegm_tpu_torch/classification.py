"""Supervised classification: the random forest and the single decision
tree, CV iterators, dataset balancing, the fold-batched hyper-parameter
search and persistence (port of the forest part of
``pyimsegm_tpu.classification``).

The classifier's scaler and PCA are fitted on the host in numpy, as the
reference fits them; the forest is fitted and applied on the classifier's
device (``'cuda'`` unless the caller asks for ``'cpu'``).  The CV folds and
the search candidates are drawn from numpy and equal the reference's.
:func:`classifier_from_numpy` carries a classifier fitted by the JAX
package across.  The other classifiers of the reference (GradBoost,
AdaBoost, LogistRegr, SVM, KNN, MLP) raise ``NotImplementedError`` until
ROADMAP.md item 6 brings them.
"""

import os
import pickle

import numpy as np
import torch

from pyimsegm_tpu_torch.models import forest as forest_mod
from pyimsegm_tpu_torch.utils.device import as_tensor

#: default classifier
DEFAULT_CLASSIF_NAME = 'RandForest'
#: file name pattern of saved classifiers
TEMPLATE_NAME_CLF = 'classifier_{}.pkl'
#: the classifiers this port has
PORTED_CLASSIFIERS = ('RandForest', 'DecTree')
#: the reference's other classifiers
UNPORTED_CLASSIFIERS = ('GradBoost', 'AdaBoost', 'LogistRegr', 'SVM', 'KNN',
                        'MLP')

#: randomised hyper-parameter distributions
CLF_PARAM_DISTRIBUTIONS = {
    'RandForest': {'n_trees': [16, 32, 64], 'depth': [6, 8, 10],
                   'n_candidates': [4, 8, 16]},
    'DecTree': {'depth': [8, 12, 16]},
}


def _check_name(name):
    if name in UNPORTED_CLASSIFIERS:
        raise NotImplementedError('classifier %r comes with ROADMAP.md item 6'
                                  % name)
    if name not in PORTED_CLASSIFIERS:
        raise ValueError('unknown classifier: %r' % name)


def _forest_kwargs(name, hyper):
    """forest_fit keywords of a classifier name and its hyper-parameters."""
    if name == 'DecTree':
        return dict(n_trees=1, depth=hyper.get('depth', 12),
                    n_candidates=hyper.get('n_candidates', 32),
                    bootstrap=False)
    return dict(n_trees=hyper.get('n_trees', 32), depth=hyper.get('depth', 8),
                n_candidates=hyper.get('n_candidates', 8))


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Classifier:
    """Scaler + optional PCA + forest, with ``fit`` / ``predict`` /
    ``predict_proba`` / ``classes_``.

    :param device: where the forest is fitted and applied
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
        self._params = forest_mod.forest_fit(
            gen, as_tensor(xs.astype(np.float32), dev),
            as_tensor(y_dense, dev), as_tensor(w, dev), len(self.classes_),
            **_forest_kwargs(self.name, self.hyper))
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

    def predict_proba(self, features):
        """(N, C) class probabilities: a tensor on the classifier's device
        for a tensor input, else a numpy array."""
        if self._params is None:
            raise RuntimeError('classifier is not fitted')
        proba = forest_mod.forest_predict_proba(self._params,
                                                self.transform(features))
        return proba if isinstance(features, torch.Tensor) else \
            proba.cpu().numpy()

    def predict(self, features):
        """Class labels (from ``classes_``) as a numpy array."""
        proba = _numpy(self.predict_proba(features))
        return self.classes_[np.argmax(proba, axis=1)]

    def score(self, features, labels):
        return float(np.mean(self.predict(features) == _numpy(labels)))


def classifier_from_numpy(d, name=DEFAULT_CLASSIF_NAME, device='cuda'):
    """A fitted :class:`Classifier` from plain arrays: ``scaler_mean``,
    ``scaler_std``, optional ``pca`` (D, P), the forest's ``feat``, ``thr``,
    ``leaf_proba`` and ``depth``, and ``classes``.  This is how a classifier
    fitted by the JAX package is carried across."""
    clf = Classifier(name, device=device)
    clf.classes_ = np.asarray(d['classes'])
    clf._scaler = (np.asarray(d['scaler_mean'], np.float32),
                   np.asarray(d['scaler_std'], np.float32))
    clf._pca = None if d.get('pca') is None else np.asarray(d['pca'])
    dev = clf.device
    clf._params = forest_mod.ForestParams(
        torch.as_tensor(np.asarray(d['feat'], np.int64), device=dev),
        torch.as_tensor(np.array(d['thr'], np.float32), device=dev),
        torch.as_tensor(np.array(d['leaf_proba'], np.float32), device=dev),
        int(d['depth']))
    return clf


def classifier_to_numpy(clf):
    """The arrays :func:`classifier_from_numpy` reads."""
    p = clf._params
    out = {'classes': np.asarray(clf.classes_),
           'scaler_mean': np.asarray(clf._scaler[0], np.float32),
           'scaler_std': np.asarray(clf._scaler[1], np.float32),
           'feat': _numpy(p.feat).astype(np.int32),
           'thr': _numpy(p.thr).astype(np.float32),
           'leaf_proba': _numpy(p.leaf_proba).astype(np.float32),
           'depth': np.asarray(int(p.depth), np.int32)}
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
    batched forest fit: fold b is standardised over its own training rows
    and trained on them (weight 1), and scored on the rest."""
    xd, yd = as_tensor(x, device), as_tensor(y, device).to(torch.int64)
    w = as_tensor(w_tr, device)
    wsum = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
    mu = (w @ xd / wsum)[:, None, :]                         # (B, 1, F)
    sd = torch.sqrt(torch.sum(((xd[None] - mu) ** 2) * w[..., None], dim=1,
                              keepdim=True) / wsum[..., None]) + 1e-12
    xs = (xd[None] - mu) / sd                                # (B, N, F)
    kw = _forest_kwargs(clf_name, hyper)
    gen = torch.Generator(device=xd.device).manual_seed(int(seed))
    p = forest_mod.forest_fit(gen, xs, yd, w, n_classes, **kw)
    pred = torch.argmax(forest_mod._forest_predict(
        p.feat, p.thr, p.leaf_proba, kw['depth'], xs), dim=-1)
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
    fit over the folds per candidate (the forests' knobs all set shapes).

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
    """Accuracy per CV fold: one batched fit without PCA, else a host loop
    of fits."""
    _check_name(clf_name)
    features = np.asarray(features)
    labels = np.asarray(labels)
    folds = list(_cross_val(cross_val, len(labels), seed))
    if pca_coef is None:
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
        if pca_coef is None:
            folds = list(_cross_val(cross_val, len(labels), seed))
            scores = _eval_cv_search_batched(clf_name, features, labels,
                                             folds, seed, candidates, device)
        else:
            scores = [float(np.mean(eval_classif_cross_val_scores(
                clf_name, features, labels, cross_val=cross_val,
                pca_coef=pca_coef, seed=seed, device=device, **hyper)))
                for hyper in candidates]
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
