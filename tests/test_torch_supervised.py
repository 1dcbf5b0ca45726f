"""The supervised 2D path of the port (BASELINE config 2: colour + Gabor +
LBP features, random forest, CV search, MRF) vs the JAX package on the CPU:
segmentation with a JAX-trained forest carried across, and training end to
end."""

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
