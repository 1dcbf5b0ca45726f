"""The port's unsupervised segmentation and superpixel apps
(``pyimsegm_tpu_torch.apps``), its webapp and demo against the JAX
package's apps on the same files, on the CPU, on ``tests/test_apps.py``'s
tiny dataset (two 60x90 images of three vertical bands, their annotations).
The supervised app is in ``tests/test_torch_apps_sup.py``.

Each JAX app runs once in a module fixture.  Bars: every exported
segmentation has ARS >= 0.98 against JAX's and >= 0.999 of its labels equal
(the class models are random fits in both packages; on bands this clear
both find them); soft maps within 1e-5; the CSVs have JAX's
columns by name, with scores within 0.02 and the superpixel boundary
distances, which rest on the deterministic SLIC, within 1e-6.  Each app's
output also equals the port's library call on the same loaded image:
labels exactly, soft maps within 1e-6."""

import os
import shutil
import sys

import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from PIL import Image  # noqa: E402

from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402

ARS_BAR, LABELS_BAR, SOFT_ATOL, SCORE_ATOL = 0.98, 0.999, 1e-5, 0.02
NAMES = ('img_0', 'img_1')
#: the unsupervised app's parameters (the bands separate on their mean)
UNSUP = {'nb_classes': 3, 'slic_size': 10, 'slic_regul': 0.3,
         'run_groupGMM': True, 'features': {'color': ['mean']}}


@pytest.fixture(scope='module')
def tiny_dataset(tmp_path_factory):
    """Two tiny images + annotations with 3 vertical bands; the second copy
    has image 0's annotation RGB-coded (the loader takes channel 0)."""
    root = tmp_path_factory.mktemp('data')
    (root / 'image').mkdir()
    (root / 'annot').mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        annot = np.zeros((60, 90), np.uint8)
        annot[:, 30:60] = 1
        annot[:, 60:] = 2
        img = (np.stack([annot * 100 + 20] * 3, -1)
               + rng.normal(0, 6, (60, 90, 3))).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / 'image' / ('img_%i.jpg' % i))
        Image.fromarray(annot).save(root / 'annot' / ('img_%i.png' % i))
    rgb = root.parent / (root.name + '_rgb')
    shutil.copytree(root, rgb)
    a = np.asarray(Image.open(rgb / 'annot' / 'img_0.png'))
    Image.fromarray(np.stack([a, a * 0, a * 0], -1)).save(
        rgb / 'annot' / 'img_0.png')
    return root, rgb


def _unsup(app, data, out, **extra):
    params = dict(app.SEGM_PARAMS)
    params.update(UNSUP, path_predict_imgs=str(data / 'image' / '*.jpg'),
                  path_out=str(out), **extra)
    app.main(params)
    return out / 'experiment_segm-unSupervised_imgDisk'


def _eval_sp(app, data, out, **extra):
    return app.compute_boundary_distance(dict({
        'path_images': str(data / 'image' / '*.jpg'),
        'path_segms': str(data / 'annot' / '*.png'),
        'path_out': str(out), 'img_type': '2d_rgb',
        'slic_size': 10, 'slic_regul': 0.3}, **extra))


@pytest.fixture(scope='module')
def runs(tiny_dataset, tmp_path_factory):
    """Each app of the JAX package and of the port, once, on the same
    files; returns their output folders and frames."""
    from apps import run_eval_superpixels as jeval
    from apps import run_segm_slic_model_graphcut as junsup
    from pyimsegm_tpu_torch.apps import run_eval_superpixels as teval
    from pyimsegm_tpu_torch.apps import run_segm_slic_model_graphcut as tunsup

    data, _ = tiny_dataset
    out = tmp_path_factory.mktemp('runs')
    res = {'unsup': (_unsup(junsup, data, out / 'jax'),
                     _unsup(tunsup, data, out / 'torch', device='cpu'))}
    res['eval'] = (_eval_sp(jeval, data, out / 'jax_eval'),
                   _eval_sp(teval, data, out / 'torch_eval', device='cpu'))
    return res


def _png(path):
    return np.asarray(Image.open(path)).astype(int)


def _same_segm(a, b):
    assert a.shape == b.shape
    assert adjusted_rand_score(a.ravel(), b.ravel()) >= ARS_BAR
    assert (a == b).mean() >= LABELS_BAR


def _same_csv(path_a, path_b, atol=SCORE_ATOL):
    import pandas as pd
    dfa = pd.read_csv(path_a, index_col=0)
    dfb = pd.read_csv(path_b, index_col=0)
    assert list(dfa.columns) == list(dfb.columns)
    assert list(dfa.index) == list(dfb.index)
    num = dfa.select_dtypes('number').columns
    np.testing.assert_allclose(dfb[num].values, dfa[num].values, rtol=0,
                               atol=atol)
    return dfa, dfb


@pytest.mark.parametrize('sub', ['segm_single', 'segm_group'])
def test_unsup_app_matches_jax(runs, sub):
    jdir, tdir = runs['unsup']
    for name in NAMES:
        _same_segm(_png(tdir / sub / (name + '.png')),
                   _png(jdir / sub / (name + '.png')))
        soft_t = np.load(tdir / sub / (name + '.npz'))['segm_soft']
        soft_j = np.load(jdir / sub / (name + '.npz'))['segm_soft']
        np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=SOFT_ATOL)
    _same_csv(jdir / 'metric_ARS.csv', tdir / 'metric_ARS.csv')
    assert (tdir / 'config.yml').exists()
    assert (tdir / 'resultStat.txt').exists()


def test_unsup_app_equals_library_calls(runs, tiny_dataset):
    """Each exported map is the library call on the same loaded image, and
    the pickled group model reloads and segments image 0 the same."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.apps import common
    from pyimsegm_tpu_torch.apps import run_segm_slic_model_graphcut as app
    from pyimsegm_tpu_torch.labeling import assume_bg_on_boundary
    params = dict(app.SEGM_PARAMS, **UNSUP)
    _, tdir = runs['unsup']
    model = app.load_class_model(str(tdir / app.NAME_MODEL), device='cpu')
    for name in NAMES:
        img, _ = common.load_image_by_type(
            str(tiny_dataset[0] / 'image' / (name + '.jpg')))
        segm, soft = pipelines.pipe_color2d_slic_features_model_graphcut(
            img, 3, params['features'], sp_size=params['slic_size'],
            sp_regul=params['slic_regul'], gc_regul=params['gc_regul'],
            device='cpu')
        np.testing.assert_array_equal(
            _png(tdir / 'segm_single' / (name + '.png')),
            assume_bg_on_boundary(segm, bg_label=0))
        np.testing.assert_allclose(
            np.load(tdir / 'segm_single' / (name + '.npz'))['segm_soft'],
            soft, rtol=0, atol=1e-6)
        segm, soft = pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, params['features'], sp_size=params['slic_size'],
            sp_regul=params['slic_regul'], gc_regul=params['gc_regul'])
        np.testing.assert_array_equal(
            _png(tdir / 'segm_group' / (name + '.png')),
            assume_bg_on_boundary(segm, bg_label=0))
        np.testing.assert_allclose(
            np.load(tdir / 'segm_group' / (name + '.npz'))['segm_soft'],
            soft, rtol=0, atol=1e-6)


def test_class_model_pickle_round_trip(runs):
    """The pickle holds numpy arrays only, under ``class_model_from_numpy``'s
    names."""
    import pickle

    from pyimsegm_tpu_torch.apps import run_segm_slic_model_graphcut as app
    from pyimsegm_tpu_torch.models.class_model import class_model_to_numpy
    path = runs['unsup'][1] / app.NAME_MODEL
    with open(path, 'rb') as fp:
        arrays = pickle.load(fp)
    assert {'weights', 'means', 'covs'} <= set(arrays)
    assert all(v is None or isinstance(v, np.ndarray)
               for v in arrays.values())
    again = class_model_to_numpy(app.load_class_model(str(path), 'cpu'))
    for key, val in arrays.items():
        if val is None:
            assert again[key] is None
        else:
            np.testing.assert_array_equal(again[key], val)


def test_eval_superpixels_app_matches_jax(runs):
    dfj, dft = runs['eval']
    assert list(dft.columns) == list(dfj.columns) == ['mean', 'std', 'max']
    assert list(dft.index) == list(dfj.index)
    np.testing.assert_allclose(dft.values, dfj.values, rtol=0, atol=1e-6)
    assert (dft['mean'] < 10).all()


def test_eval_superpixels_app_equals_library_call(runs, tiny_dataset):
    from pyimsegm_tpu_torch.apps import common
    from pyimsegm_tpu_torch.labeling import compute_boundary_distances
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    dft = runs['eval'][1]
    for name in NAMES:
        img, _ = common.load_image_by_type(
            str(tiny_dataset[0] / 'image' / (name + '.jpg')))
        annot, _ = common.load_annot_2d(
            str(tiny_dataset[0] / 'annot' / (name + '.png')))
        slic = segment_slic_img2d(img, sp_size=10, relative_compact=0.3,
                                  device='cpu')
        _, dists = compute_boundary_distances(annot, slic)
        assert dft.loc[name, 'mean'] == float(np.mean(dists))
        assert dft.loc[name, 'max'] == float(np.max(dists))


def test_common_loaders_match_jax(tiny_dataset, tmp_path):
    """Image and annotation loading by type, and the experiment folder."""
    from apps import common as jcommon
    from pyimsegm_tpu_torch.apps import common as tcommon
    data, rgb = tiny_dataset
    for img_type in tcommon.TYPES_LOAD_IMAGE:
        got = tcommon.load_image_by_type(str(data / 'image' / 'img_0.jpg'),
                                         img_type)
        want = jcommon.load_image_by_type(str(data / 'image' / 'img_0.jpg'),
                                          img_type)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for path in (data / 'annot' / 'img_1.png', rgb / 'annot' / 'img_0.png'):
        got, want = tcommon.load_annot_2d(str(path)), \
            jcommon.load_annot_2d(str(path))
        np.testing.assert_array_equal(got[0], want[0])
    assert tcommon.find_images_annots(
        str(data / 'image' / '*.jpg'), str(data / 'annot' / '*.png')) == \
        jcommon.find_images_annots(str(data / 'image' / '*.jpg'),
                                   str(data / 'annot' / '*.png'))
    params = {'path_out': str(tmp_path / 'out'), 'name': 'x', 'a': [1, 2]}
    path = tcommon.setup_experiment(dict(params), 'exp')
    assert os.path.basename(path) == 'exp_x'
    assert yaml.safe_load(open(os.path.join(path, 'config.yml')))['a'] == \
        [1, 2]


def test_webapp_form_and_segmentation(tiny_dataset):
    """The stdlib web UI: the form renders, and its compute function
    returns the two PNG sheets of the JAX app's."""
    import base64

    from pyimsegm_tpu_torch.apps import webapp_segmentation as web
    page = web.PAGE.format(options='<option>a</option>', body='',
                           nb_classes=3, sp_size=30, sp_regul=0.5,
                           gc_regul=0.4)
    assert '<form' in page and 'sp_regul' in page
    figs = web.run_segmentation(str(tiny_dataset[0] / 'image' / 'img_0.jpg'),
                                nb_classes=3, sp_size=12, sp_regul=0.4,
                                gc_regul=0.5, device='cpu')
    assert [n for n, _ in figs] == ['superpixels', 'segmentation']
    for _name, b64 in figs:
        assert base64.b64decode(b64)[:4] == b'\x89PNG'


def test_demo_app_equals_library_call(tiny_dataset, tmp_path):
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.apps import common
    from pyimsegm_tpu_torch.apps import demo_interactive_segmentation as demo
    path = str(tiny_dataset[0] / 'image' / 'img_1.jpg')
    segm = demo.main({'path_image': path, 'path_out': str(tmp_path),
                      'nb_classes': 3, 'sp_size': 10, 'sp_regul': 0.2,
                      'gc_regul': 1.0, 'show': False, 'device': 'cpu'})
    assert (tmp_path / 'img_1_demo.png').exists()
    img, _ = common.load_image_by_type(path)
    feats = {'color': ['mean', 'std', 'energy']}
    model, _ = pipelines.estim_model_classes_group(
        [img], 3, feats, sp_size=10, sp_regul=0.2, device='cpu')
    want, _ = pipelines.segment_color2d_slic_features_model_graphcut(
        img, model, feats, sp_size=10, sp_regul=0.2, gc_regul=1.0)
    np.testing.assert_array_equal(segm, want)
