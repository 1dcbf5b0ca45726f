"""The port's random forest and classification helpers vs the JAX package
on the CPU: prediction with carried parameters (exact up to the mean's
rounding), the fit by accuracy (the random draws differ; also on classes
that overlap), and the CV folds,
balancing, datasets and search candidates (numpy draws, exact)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import classification as jclf
from pyimsegm_tpu.models import forest as jforest
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import classification as tclf
from pyimsegm_tpu_torch.models import forest as tforest

from torch_threads import one_torch_thread  # noqa: F401


def _blobs(n_per_class, n_feat, seed, n_classes=3, spread=1.0):
    """Gaussian classes around random centres, labels 1..n_classes."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(n_classes, n_feat))
    x = np.concatenate([c + rng.normal(scale=spread, size=(n_per_class,
                                                           n_feat))
                        for c in centres]).astype(np.float32)
    y = np.repeat(np.arange(1, n_classes + 1), n_per_class)
    return x, y


@pytest.fixture(scope='module')
def jax_forest():
    """A JAX forest fitted on noisy blobs (with empty leaves and
    unsplittable nodes), and its inputs."""
    x, y = _blobs(60, 6, 0, spread=2.5)
    yd = (y - 1).astype(np.int32)
    params = jforest.forest_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(yd), jnp.ones(len(x)), 3,
                                n_trees=12, depth=6, n_candidates=4)
    return params, x, yd


def test_forest_predict_equals_jax(jax_forest):
    params, x, _ = jax_forest
    depth = int(params.depth)
    xq = np.concatenate([x, np.random.default_rng(1).normal(
        scale=4.0, size=(50, x.shape[1])).astype(np.float32)])
    feat = torch.as_tensor(np.asarray(params.feat, np.int64))
    thr = torch.as_tensor(np.array(params.thr))
    leaf = torch.as_tensor(np.array(params.leaf_proba))
    for reduce_mean in (True, False):
        want = np.asarray(jforest._forest_predict_jit(
            params.feat, params.thr, params.leaf_proba, depth,
            jnp.asarray(xq), reduce_mean=reduce_mean))
        got = tforest._forest_predict(feat, thr, leaf, depth,
                                      torch.as_tensor(xq),
                                      reduce_mean=reduce_mean)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # batched over a leading fold axis: each fold its own forest and x
    got = tforest._forest_predict(torch.stack([feat, feat.flip(0)]),
                                  torch.stack([thr, thr.flip(0)]),
                                  torch.stack([leaf, leaf.flip(0)]), depth,
                                  torch.as_tensor(np.stack([xq, xq[::-1]])))
    want = np.asarray(jforest._forest_predict_jit(
        params.feat, params.thr, params.leaf_proba, depth, jnp.asarray(xq)))
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want[::-1], atol=1e-6)


@pytest.mark.parametrize('name', ['RandForest', 'DecTree'])
def test_fit_accuracy_matches_jax(name):
    """The fits draw different random numbers, so they are held by
    accuracy: training and held-out, within 0.02 of JAX's."""
    x, y = _blobs(120, 8, 2, spread=2.0)
    xt, yt = _blobs(120, 8, 2, spread=2.0)
    xt = xt + np.random.default_rng(5).normal(scale=0.5, size=xt.shape) \
        .astype(np.float32)
    # a shallower tree than DecTree's default keeps JAX's compile short
    hyper = {'depth': 6, 'n_candidates': 16} if name == 'DecTree' else {}
    cj = jclf.Classifier(name, seed=0, **hyper).fit(x, y)
    ct = tclf.Classifier(name, seed=0, device='cpu', **hyper).fit(x, y)
    for xs, ys in ((x, y), (xt, yt)):
        assert ct.score(xs, ys) >= cj.score(xs, ys) - 0.02
    np.testing.assert_array_equal(ct.classes_, cj.classes_)
    proba = ct.predict_proba(torch.as_tensor(x))
    assert isinstance(proba, torch.Tensor) and proba.shape == (len(x), 3)
    np.testing.assert_allclose(proba.sum(dim=1).numpy(), 1.0, atol=1e-5)


def _noisy_pixels(seeds, size=(48, 64)):
    """Per-pixel RGB of ``sample_color_image_rand_segment`` images with
    added N(0, 0.2) noise, so that the class colours overlap (each image
    also draws its own class colours), and the class ids 1..3."""
    xs, ys = [], []
    for s in seeds:
        img, seg = sample_color_image_rand_segment(size, 3, rand_seed=s)
        img = img + np.random.default_rng(100 + s).normal(scale=0.2,
                                                           size=img.shape)
        xs.append(img.reshape(-1, 3).astype(np.float32))
        ys.append(seg.reshape(-1) + 1)
    return np.concatenate(xs), np.concatenate(ys)


def test_forest_fit_on_overlapping_classes_matches_jax():
    """A training set where the classes overlap: the forests' accuracies
    differ from 1.0, and the port's stays within 0.02 of JAX's on the
    training half and on the held-out half."""
    x, y = _noisy_pixels((0, 1, 2))
    cj = jclf.Classifier('RandForest', seed=0).fit(x[0::2], y[0::2])
    ct = tclf.Classifier('RandForest', seed=0, device='cpu').fit(x[0::2],
                                                                 y[0::2])
    for part in (slice(0, None, 2), slice(1, None, 2)):
        acc_j, acc_t = cj.score(x[part], y[part]), ct.score(x[part], y[part])
        print('forest accuracy on overlapping classes (%s half): JAX %.4f, '
              'port %.4f' % ('training' if part.start == 0 else 'held-out',
                             acc_j, acc_t))
        assert 0.5 < acc_j < 0.98
        assert acc_t >= acc_j - 0.02


def test_fit_deterministic_for_a_seed():
    x, y = _blobs(80, 5, 3, spread=2.0)
    fits = [tclf.Classifier('RandForest', seed=s, device='cpu').fit(x, y)
            for s in (7, 7, 8)]
    a, b, c = (tclf.classifier_to_numpy(f) for f in fits)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a['thr'], c['thr'])


def test_fold_batched_fit_equals_single_folds():
    """Fold b of a batched fit is the fit of fold b's weights alone, given
    the same draws: held with one fold, whose draws are the same."""
    x, y = _blobs(40, 4, 4, spread=2.0)
    yd = torch.as_tensor(y - 1)
    w = torch.as_tensor((np.random.default_rng(0).random(len(x)) > 0.3)
                        .astype(np.float32))
    single = tforest.forest_fit(torch.Generator().manual_seed(3),
                                torch.as_tensor(x), yd, w, 3, n_trees=4,
                                depth=4, n_candidates=4)
    batched = tforest.forest_fit(torch.Generator().manual_seed(3),
                                 torch.as_tensor(x)[None], yd, w[None], 3,
                                 n_trees=4, depth=4, n_candidates=4)
    for a, b in zip(single[:3], batched[:3]):
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())


def _folds(cv):
    return [(list(map(int, tr)), list(map(int, te))) for tr, te in cv]


def test_cv_iterators_equal_jax():
    for seed in (None, 0, 5):
        assert _folds(tclf.CrossValidate(57, 10, rand_seed=seed)) == \
            _folds(jclf.CrossValidate(57, 10, rand_seed=seed))
        assert _folds(tclf.HoldOut(20, 7, rand_seed=seed)) == \
            _folds(jclf.HoldOut(20, 7, rand_seed=seed))
        sizes = [5, 9, 3, 7, 4, 6]
        assert _folds(tclf.CrossValidateGroups(sizes, 2, rand_seed=seed)) \
            == _folds(jclf.CrossValidateGroups(sizes, 2, rand_seed=seed))
    assert len(tclf.CrossValidate(57, 10)) == len(jclf.CrossValidate(57, 10))


def test_balancing_and_dataset_equal_jax():
    rng = np.random.default_rng(0)
    x = np.round(rng.random((90, 3)) * 3).astype(np.float32)   # duplicates
    y = rng.integers(0, 3, 90)
    for kind in ('unique', 'random'):
        ft, lt = tclf.balance_dataset_by_(x, y, kind, rand_seed=2)
        fj, lj = jclf.balance_dataset_by_(x, y, kind, rand_seed=2)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(lt, lj)
    # k-means draws its seeds from the generator: counts and ranges
    ft, lt = tclf.balance_dataset_by_(x, y, 'kmeans', device='cpu')
    _, lj = jclf.balance_dataset_by_(x, y, 'kmeans')
    np.testing.assert_array_equal(lt, lj)
    assert ft.shape == (len(lj), 3) and (ft >= 0).all() and (ft <= 3).all()
    feats = {i: rng.random((12, 4)) for i in range(3)}
    labels = {i: rng.integers(-1, 3, 12) for i in range(3)}
    for balance in (None, 'unique'):
        got = tclf.convert_set_features_labels_2_dataset(
            feats, labels, drop_labels=[-1], balance_type=balance)
        want = jclf.convert_set_features_labels_2_dataset(
            feats, labels, drop_labels=[-1], balance_type=balance)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name,cross_val', [
    ('RandForest', 10), ('DecTree', 4),
    ('RandForest', 'groups')])
def test_search_candidates_and_folds_equal_jax(name, cross_val):
    x, y = _blobs(30, 4, 6, spread=2.0)
    if cross_val == 'groups':
        cross_val = tclf.CrossValidateGroups([30, 25, 35], 1)
    seen = {}

    def record(key):
        def fake(clf_name, features, labels, folds, seed, candidates,
                 device=None):
            seen[key] = (_folds(folds), list(candidates))
            return np.arange(len(candidates), dtype=np.float64)[::-1]
        return fake

    # JAX's final fit is not what is held here (and compiles for minutes at
    # DecTree's depth)
    with mock.patch.object(jclf, '_eval_cv_search_batched', record('jax')), \
            mock.patch.object(jclf.Classifier, 'fit', lambda self, *a: self):
        _, hj = jclf.create_classif_search_train_export(
            name, x, y, cross_val=cross_val, nb_search_iter=5, seed=3)
    with mock.patch.object(tclf, '_eval_cv_search_batched', record('port')):
        ct, ht = tclf.create_classif_search_train_export(
            name, x, y, cross_val=cross_val, nb_search_iter=5, seed=3,
            device='cpu')
    assert seen['port'] == seen['jax'] and ht == hj
    assert ct.score(x, y) >= 0.9


def test_cv_scores_and_search_run():
    x, y = _blobs(40, 4, 7, spread=0.5)
    for pca in (None, 0.9):
        scores = tclf.eval_classif_cross_val_scores('RandForest', x, y,
                                                    cross_val=5, pca_coef=pca,
                                                    device='cpu', n_trees=8)
        assert len(scores) == 5 and min(scores) >= 0.8
    clf, hyper = tclf.create_classif_search_train_export(
        'RandForest', x, y, cross_val=4, nb_search_iter=3, device='cpu')
    assert set(hyper) <= set(tclf.CLF_PARAM_DISTRIBUTIONS['RandForest'])
    assert clf.score(x, y) >= 0.95


def _jax_arrays(cj):
    p = cj._params
    d = {'classes': cj.classes_, 'scaler_mean': cj._scaler[0],
         'scaler_std': cj._scaler[1], 'feat': np.asarray(p.feat),
         'thr': np.asarray(p.thr), 'leaf_proba': np.asarray(p.leaf_proba),
         'depth': p.depth}
    if cj._pca is not None:
        d['pca'] = cj._pca
    return d


@pytest.mark.parametrize('pca', [None, 0.9])
def test_classifier_from_numpy_round_trip(tmp_path, pca):
    x, y = _blobs(50, 5, 8, spread=2.5)
    cj = jclf.Classifier('RandForest', pca_coef=pca, seed=1,
                         n_trees=8).fit(x, y)
    ct = tclf.classifier_from_numpy(_jax_arrays(cj), device='cpu')
    xq = x + np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    # the device path of the reference: f32 scaler (and PCA) on the device
    apply, arrays = cj.device_predict_fn()
    want = np.asarray(apply(arrays, jnp.asarray(xq)))
    np.testing.assert_allclose(ct.predict_proba(xq), want, atol=1e-6)
    np.testing.assert_array_equal(ct.predict(xq),
                                  cj.classes_[np.argmax(want, 1)])
    path = tclf.save_classifier(str(tmp_path), ct, 'rf')
    back = tclf.load_classifier(path, device='cpu')
    np.testing.assert_array_equal(back.predict_proba(xq),
                                  ct.predict_proba(xq))
    for k, v in tclf.classifier_to_numpy(ct).items():
        np.testing.assert_array_equal(tclf.classifier_to_numpy(back)[k], v)


@pytest.mark.parametrize('name', tclf.UNPORTED_CLASSIFIERS)
def test_unported_classifiers_raise(name):
    with pytest.raises(NotImplementedError, match='item 6'):
        tclf.Classifier(name, device='cpu')
    with pytest.raises(ValueError):
        tclf.Classifier('nope', device='cpu')
