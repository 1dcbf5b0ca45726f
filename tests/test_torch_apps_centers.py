"""The port's centre-detection chain of apps
(``run_center_candidate_training``, ``run_center_prediction``,
``run_center_clustering``,
``run_center_evaluation``) against the JAX package's apps on the same
files, on the CPU: the 200x260 slices of ``tests/test_torch_apps_ovary.py``,
training on slices 0-1 with leave-one-out, prediction on slices 2-5, at
``tests/test_torch_centers.py``'s small-size parameters.

Each JAX app runs once in a module fixture.  The forests are random fits
in both packages: the training app is held by its candidate labels (exact:
they rest on the deterministic SLIC and the annotated centres) and its
leave-one-out F1 (within 0.15 of JAX's: on two training scenes of four eggs
one egg found or missed moves it by ~0.1); the prediction app runs JAX's
forest carried into the port's pickle (``classifier_from_numpy``), and
then its candidate and centre CSVs equal JAX's within 1e-6.  Clustering and
evaluation run on the same CSVs, with equal results."""

import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))

from make_torch_port_fixture import _clf_arrays  # noqa: E402
from test_torch_apps_ovary import ovary_dataset  # noqa: F401,E402
from test_torch_apps_segm import _same_csv  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402

F1_SLACK = 0.15
#: ``tests/test_torch_centers.py``'s parameters of the chain at this size
SMALL = dict(slic_size=10, slic_regul=0.3, fts_hist_diams=[4, 8, 16],
             fts_ray_step=30, center_dist_thr=8, nb_classif_search=1,
             DBSCAN_max_dist=8, name='ovary')
PREDICT = ('slice_2', 'slice_3', 'slice_4', 'slice_5')


def _stat(path):
    """The statistics block of an experiment's ``resultStat.txt``."""
    text = open(path).read().split('STATISTICS:')[1]
    return {line.split(':')[0].strip().strip('"'):
            float(line.split(':')[1]) for line in text.splitlines()
            if line.startswith('"')}


@pytest.fixture(scope='module')
def runs(ovary_dataset, tmp_path_factory):
    from apps import run_center_candidate_training as jtr
    from apps import run_center_clustering as jcl
    from apps import run_center_evaluation as jev
    from apps import run_center_prediction as jpr
    from pyimsegm_tpu import centers as jctr
    from pyimsegm_tpu.classification import load_classifier
    from pyimsegm_tpu_torch.apps import run_center_candidate_training as ttr
    from pyimsegm_tpu_torch.apps import run_center_clustering as tcl
    from pyimsegm_tpu_torch.apps import run_center_evaluation as tev
    from pyimsegm_tpu_torch.apps import run_center_prediction as tpr
    from pyimsegm_tpu_torch.classification import (classifier_from_numpy,
                                                   save_classifier)
    root = ovary_dataset
    out = tmp_path_factory.mktemp('runs')
    params = dict(jctr.CENTER_PARAMS, **jctr.CLUSTER_PARAMS)
    params.update(SMALL, path_list=str(root / 'list_train.csv'))
    jtr.main(dict(params, path_out=str(out / 'jtr')))
    ttr.main(dict(params, path_out=str(out / 'ttr'), device='cpu'))
    path_clf = out / 'jtr' / 'detect-centers-train_ovary' / \
        'classifier_RandForest.pkl'
    (out / 'carried').mkdir()
    save_classifier(str(out / 'carried'), classifier_from_numpy(
        _clf_arrays(load_classifier(str(path_clf))), device='cpu'),
        'RandForest')
    pred = dict(params, path_images=str(root / 'image' / 'slice_[2-5].png'),
                path_segms=str(root / 'segm' / 'slice_[2-5].png'))
    jpr.main(dict(pred, path_out=str(out / 'jpr'), path_classif=str(path_clf)))
    tpr.main(dict(pred, path_out=str(out / 'tpr'), device='cpu',
                  path_classif=str(out / 'carried'
                                   / 'classifier_RandForest.pkl')))
    cands = str(out / 'jpr' / 'detect-centers-predict_ovary' / 'candidates'
                / '*.csv')
    jcl.main(dict(params, path_points=cands, path_out=str(out / 'jcl')))
    tcl.main(dict(params, path_points=cands, path_out=str(out / 'tcl'),
                  device='cpu'))
    ev = {'path_centers': str(out / 'jpr' / 'detect-centers-predict_ovary'
                              / 'centres' / '*.csv'),
          'path_annots': str(root / 'centers' / '*.csv'), 'dist_thr': 8}
    jev.main(dict(ev, path_out=str(out / 'jev')))
    tev.main(dict(ev, path_out=str(out / 'tev'), device='cpu'))
    return out


def test_training_app_matches_jax(runs):
    jdir = runs / 'jtr' / 'detect-centers-train_ovary'
    tdir = runs / 'ttr' / 'detect-centers-train_ovary'
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    jdump = np.load(jdir / 'dump_training_data.npz')
    tdump = np.load(tdir / 'dump_training_data.npz')
    assert sorted(tdump.files) == sorted(jdump.files)
    for key in jdump.files:
        np.testing.assert_array_equal(tdump[key], jdump[key])
    with open(tdir / 'center_params.pkl', 'rb') as fp:
        tparams = pickle.load(fp)
    with open(jdir / 'center_params.pkl', 'rb') as fp:
        jparams = pickle.load(fp)
    skip = ('path_out', 'path_exp', 'device')
    assert {k: v for k, v in tparams.items() if k not in skip} == \
        {k: v for k, v in jparams.items() if k not in skip}
    f1_t = _stat(tdir / 'resultStat.txt')['LOO_mean_f1']
    f1_j = _stat(jdir / 'resultStat.txt')['LOO_mean_f1']
    assert f1_t >= f1_j - F1_SLACK


def test_trained_classifier_reloads(runs):
    from pyimsegm_tpu_torch.classification import load_classifier
    clf = load_classifier(str(runs / 'ttr' / 'detect-centers-train_ovary'
                              / 'classifier_RandForest.pkl'), device='cpu')
    assert list(clf.classes_) == [0, 1]


@pytest.mark.parametrize('sub', ['candidates', 'centres'])
def test_prediction_app_matches_jax(runs, sub):
    for name in PREDICT:
        jdf, tdf = _same_csv(
            runs / 'jpr' / 'detect-centers-predict_ovary' / sub
            / (name + '.csv'),
            runs / 'tpr' / 'detect-centers-predict_ovary' / sub
            / (name + '.csv'), atol=1e-6)
        assert list(tdf.columns) == ['Y', 'X'] and len(tdf) > 0


def test_clustering_and_evaluation_apps_match_jax(runs):
    from apps.run_center_evaluation import NAME_CSV
    for name in PREDICT:
        _same_csv(runs / 'jcl' / 'centres_clustered' / (name + '.csv'),
                  runs / 'tcl' / 'centres_clustered' / (name + '.csv'),
                  atol=0)
    _, df = _same_csv(runs / 'jev' / NAME_CSV, runs / 'tev' / NAME_CSV,
                      atol=0)
    assert list(df.index) == list(PREDICT)
    assert (df['TP'] > 0).all()
