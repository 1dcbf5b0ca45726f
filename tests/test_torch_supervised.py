"""The supervised 2D path of the port (BASELINE config 2: colour + Gabor +
LBP features, random forest, CV search, MRF) vs the JAX package on the CPU:
segmentation with a JAX-trained forest carried across, and training end to
end; and each other classifier family trained by the JAX package
(``tests/data/torch_port_fixture_clf.npz``) carried across, on its
features and through config 2 at the bench geometry."""

import os

import numpy as np
import pytest
import torch

from pyimsegm_tpu import classification as jclf
from pyimsegm_tpu import pipelines as jpipe
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu.utils.metrics import adjusted_rand_score
from pyimsegm_tpu_torch import classification as tclf
from pyimsegm_tpu_torch import pipelines as tpipe

from torch_threads import one_torch_thread  # noqa: F401

SHAPE, SP, REGUL, GC = (96, 128), 16, 0.2, 5.0
FEATURES = {'color': ['mean', 'std', 'energy'],
            'tGabor': ['mean', 'energy'], 'tLBP': ['mean']}


@pytest.fixture(scope='module')
def data():
    """Three noisy synthetic images with their annotations."""
    rng = np.random.default_rng(0)
    out = []
    for s in range(3):
        img, annot = sample_color_image_rand_segment(SHAPE, 3, rand_seed=s)
        img = np.clip(img + rng.normal(scale=0.08, size=img.shape), 0, 1)
        out.append((img.astype(np.float32), annot))
    return out


@pytest.fixture(scope='module')
def jax_trained(data):
    """The JAX package's training on the three images (no search)."""
    return jpipe.train_classif_color2d_slic_features(
        [d[0] for d in data], [d[1] for d in data], FEATURES, sp_size=SP,
        sp_regul=REGUL)


def _carried(cj):
    p = cj._params
    return tclf.classifier_from_numpy(
        {'classes': cj.classes_, 'scaler_mean': cj._scaler[0],
         'scaler_std': cj._scaler[1], 'feat': np.asarray(p.feat),
         'thr': np.asarray(p.thr), 'leaf_proba': np.asarray(p.leaf_proba),
         'depth': int(p.depth)}, device='cpu')


@pytest.mark.parametrize('connectivity', [True, False])
def test_segment_with_carried_jax_forest(data, jax_trained, connectivity):
    img = data[0][0]
    cj = jax_trained[0]
    dj, dt = {}, {}
    segm_j, soft_j = jpipe.segment_color2d_slic_features_model_graphcut(
        img, cj, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj, connectivity=connectivity)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        img, _carried(cj), FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dt, connectivity=connectivity)
    assert segm_t.shape == SHAPE and soft_t.shape == SHAPE + (3,)
    assert set(np.unique(segm_t)) <= set(cj.classes_)
    assert (dt['slic'] == np.asarray(dj['slic'])).mean() >= 0.999
    assert adjusted_rand_score(segm_t, segm_j) >= 0.98
    # proba of the superpixels whose pixel sets agree
    diff = dt['slic'] != np.asarray(dj['slic'])
    same = np.ones(len(dt['proba']), bool)
    same[dt['slic'][diff]] = False
    same[np.asarray(dj['slic'])[diff]] = False
    np.testing.assert_allclose(dt['proba'][same],
                               np.asarray(dj['proba'])[same], atol=1e-5)


def test_train_end_to_end(data, jax_trained):
    imgs, annots = [d[0] for d in data], [d[1] for d in data]
    cj, slic_j, _feats_j, labels_j = jax_trained
    ct, slic_t, feats_t, labels_t = tpipe.train_classif_color2d_slic_features(
        imgs, annots, FEATURES, sp_size=SP, sp_regul=REGUL,
        nb_classif_search=3, device='cpu')
    assert isinstance(ct, tclf.Classifier)
    assert len(slic_t) == len(feats_t) == len(labels_t) == 3
    for lt, lj, st, sj in zip(labels_t, labels_j, slic_t, slic_j):
        assert st.shape == SHAPE and (st == sj).mean() >= 0.999
        assert (lt == lj).mean() >= 0.99
    # held by accuracy on JAX's training set and by segmentation quality
    x, y, _ = jclf.convert_set_features_labels_2_dataset(
        dict(enumerate(_feats_j)), dict(enumerate(labels_j)),
        balance_type='unique', drop_labels=[-1])
    assert ct.score(x, y) >= cj.score(x, y) - 0.02
    segm_t, _ = tpipe.segment_color2d_slic_features_model_graphcut(
        imgs[0], ct, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC)
    segm_j, _ = jpipe.segment_color2d_slic_features_model_graphcut(
        imgs[0], cj, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC)
    assert adjusted_rand_score(segm_t, annots[0]) >= \
        adjusted_rand_score(segm_j, annots[0]) - 0.02


def test_tensor_image_runs_on_its_device(data, jax_trained):
    clf = _carried(jax_trained[0])
    img = torch.as_tensor(data[1][0])
    segm, soft = tpipe.segment_color2d_slic_features_model_graphcut(
        img, clf, FEATURES, sp_size=SP)
    assert segm.shape == SHAPE and np.isfinite(soft).all()
    clf_b = tclf.Classifier('DecTree', device='cpu')
    with pytest.raises(RuntimeError, match='not fitted'):
        tpipe.segment_color2d_slic_features_model_graphcut(img, clf_b,
                                                           FEATURES)


FIXTURE_CLF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'data', 'torch_port_fixture_clf.npz')
CLF_NAMES = ('GradBoost', 'AdaBoost', 'LogistRegr', 'SVM', 'KNN', 'MLP')
CROP, SP_CFG2, REGUL_CFG2, GC_CFG2 = (884, 1200), 35, 0.2, 5.0


@pytest.fixture(scope='module')
def fixture_clf():
    with np.load(FIXTURE_CLF) as npz:
        return {k: npz[k] for k in npz.files}


def _family(fixture, name):
    """The JAX-trained classifier of a family, carried to the CPU."""
    pre = name + '_clf_'
    return tclf.classifier_from_numpy(
        {k[len(pre):]: v for k, v in fixture.items() if k.startswith(pre)},
        name, device='cpu')


@pytest.mark.parametrize('name', CLF_NAMES)
def test_carried_family_predicts_jax_proba(fixture_clf, name):
    """Each family trained by the JAX package on config 2's features of
    images 0-2, carried across: on image 0's features ``predict_proba``
    within 1e-6 of JAX's, and the training accuracy equal.  The pipeline's
    ``device_predict_proba`` within 1e-5 of the proba inside JAX's jitted
    pipeline, whose own features differ from the stored ones in their last
    bits; AdaBoost's, clipped at 1e-10 there (1e-7 in ``predict_proba``;
    tests/test_torch_boost.py shows the two apart), within 1e-6."""
    clf = _family(fixture_clf, name)
    x = fixture_clf['features']
    got = clf.predict_proba(x)
    want = fixture_clf[name + '_proba_clf']
    print('%s carried: predict_proba max diff %.3g'
          % (name, np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = clf.device_predict_proba(x)
    want = fixture_clf[name + '_proba']
    print('%s carried: device_predict_proba max diff %.3g'
          % (name, np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if name == 'AdaBoost' else 1e-5)
    acc = clf.score(fixture_clf['train_features'],
                    fixture_clf['train_labels'])
    assert abs(acc - float(fixture_clf[name + '_train_acc'])) < 1e-9


@pytest.mark.parametrize('name', CLF_NAMES)
def test_config2_with_carried_family_matches_jax(fixture_clf, name):
    """Config 2 at the bench geometry on the CPU with each carried family
    against the JAX-CPU segmentation of image 0: enforced labels >= 0.999
    equal, ARS >= 0.98, and the proba of the unchanged superpixels within
    1e-4 but for at most 0.5 % of them.  The features agree within rtol
    1e-5 + 1e-4 (tests/test_torch_filters.py), which the linear models'
    weights carry into ~1e-4 of proba; a feature that sits that close to a
    GBT threshold or to the k-th neighbour's distance moves a superpixel's
    proba by a tree's step or a vote (1 and 2 superpixels of 875 here)."""
    img = sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0]
    dv = {}
    segm, soft = tpipe.segment_color2d_slic_features_model_graphcut(
        img, _family(fixture_clf, name), FEATURES, sp_size=SP_CFG2,
        sp_regul=REGUL_CFG2, gc_regul=GC_CFG2, debug_visual=dv)
    slic = fixture_clf['slic'].astype(np.int64)
    assert (dv['slic'] == slic).mean() >= 0.999
    diff = dv['slic'] != slic
    same = np.ones(len(dv['proba']), bool)
    same[dv['slic'][diff]] = False
    same[slic[diff]] = False
    pd = np.abs(dv['proba'] - fixture_clf[name + '_proba'])[same].max(1)
    ars = adjusted_rand_score(segm, fixture_clf[name + '_segm'])
    print('config 2 with %s: labels equal %.6f, ARS %.6f, proba max diff '
          '%.3g, superpixels above 1e-6: %d, above 1e-4: %d, of %d'
          % (name, (dv['slic'] == slic).mean(), ars, pd.max(),
             (pd > 1e-6).sum(), (pd > 1e-4).sum(), len(pd)))
    assert (pd > 1e-4).mean() <= 0.005 and ars >= 0.98
    assert np.isfinite(soft).all()
