"""The port's ovary apps (``run_RG2Sp_estim_shape_models``,
``run_ovary_egg_segmentation``) against the JAX package's apps on the same
files, on the CPU: seven 200x260 ``sample_ovary_scene`` slices of four
eggs, their class maps, egg instance maps and centre CSVs.

Each JAX app runs once in a module fixture.  The shape models are random
fits in both packages, so the zoo of the port runs on JAX's fitted models,
carried into the port's pickle (numpy arrays only) by
``run_RG2Sp_estim_shape_models.save_shape_model``; the RANSAC trials are
numpy's global draws, seeded alike.  Bars: the ray signatures within 1e-6;
each method's instance map >= 0.999 equal to JAX's, ARS >= 0.98.  The
``GC_*-small`` methods are left out: their single-seed solves sit on
near-ties that the two packages' expansion chains (threefry against a
``torch.Generator``) break apart (``tests/test_torch_region_growing.py``
holds those solves by energy)."""

import glob
import os
import pickle
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from PIL import Image  # noqa: E402

from test_torch_apps_segm import _png, _same_segm  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402

SIZE, N_EGGS, N_SCENES = (200, 260), 4, 7
#: the shape models' ray step: 15 rays, fewer than the 28 eggs (JAX's f32
#: mixture fit is NaN with fewer eggs than rays)
RAY_STEP = 25
#: the zoo's methods held here (the sample list, the snakes, the plain
#: watershed, two more boundary extractors of the criterion RANSAC)
METHODS = ('ellipse_moments', 'ellipse_ransac_mmt', 'ellipse_ransac_crit',
           'ellipse_ransac_crit2', 'ellipse_ransac_crit3', 'GC_pixels-large',
           'GC_pixels-shape', 'GC_slic-large', 'GC_slic-shape',
           'RG2SP_greedy-mixture', 'RG2SP_GC-mixture', 'RG2SP_GC-single',
           'watershed', 'watershed_morph', 'morph-snakes_img',
           'morph-snakes_seg')
#: the zoo's superpixel size at this scene size (the app's 40 at 647x1024)
ZOO_SP = 15


@pytest.fixture(scope='module')
def ovary_dataset(tmp_path_factory):
    """Slices as PNG (image, class map, egg instances) and centre CSVs
    (X, Y), plus the triple lists of the apps: slice 0 alone (the zoo) and
    slices 0-1 (centre training)."""
    import pandas as pd
    from scipy import ndimage

    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    root = tmp_path_factory.mktemp('ovary')
    for sub in ('image', 'segm', 'annot', 'centers'):
        (root / sub).mkdir()
    rows = []
    for s in range(N_SCENES):
        img, segm, centres = sample_ovary_scene(SIZE, N_EGGS, rand_seed=s)
        name = 'slice_%i' % s
        Image.fromarray((img * 255).astype(np.uint8)).save(
            root / 'image' / (name + '.png'))
        Image.fromarray(segm.astype(np.uint8)).save(
            root / 'segm' / (name + '.png'))
        Image.fromarray(ndimage.label(segm > 0)[0].astype(np.uint8)).save(
            root / 'annot' / (name + '.png'))
        pd.DataFrame({'X': centres[:, 1], 'Y': centres[:, 0]}).to_csv(
            root / 'centers' / (name + '.csv'))
        rows.append({k: str(root / sub / (name + ext)) for k, sub, ext in (
            ('path_image', 'image', '.png'), ('path_segm', 'segm', '.png'),
            ('path_centers', 'centers', '.csv'))})
    pd.DataFrame(rows[:1]).to_csv(root / 'list_zoo.csv')
    pd.DataFrame(rows[:2]).to_csv(root / 'list_train.csv')
    return root


@pytest.fixture(scope='module')
def runs(ovary_dataset, tmp_path_factory):
    from apps import run_RG2Sp_estim_shape_models as jest
    from apps import run_ovary_egg_segmentation as jzoo
    from pyimsegm_tpu_torch.apps import run_RG2Sp_estim_shape_models as test_
    from pyimsegm_tpu_torch.apps import run_ovary_egg_segmentation as tzoo
    root = ovary_dataset
    out = tmp_path_factory.mktemp('runs')
    est = {'path_annot': str(root / 'annot' / '*.png'), 'ray_step': RAY_STEP,
           'nb_components': 2}
    jest.main(dict(est, path_out=str(out / 'jshape')))
    test_.main(dict(est, path_out=str(out / 'tshape'), device='cpu'))
    (out / 'cshape').mkdir()
    for name in (jest.NAME_SINGLE, jest.NAME_MIXTURE):
        with open(out / 'jshape' / name, 'rb') as fp:
            state = pickle.load(fp)
        test_.save_shape_model(str(out / 'cshape' / name), state['name'],
                               state['model'], state['cdfs'])
    zoo = dict(jzoo.SEGM_PARAMS, path_list=str(root / 'list_zoo.csv'),
               methods=list(METHODS), slic_size=ZOO_SP, name='z')
    np.random.seed(0)
    jzoo.main(dict(zoo, path_out=str(out / 'jzoo'),
                   path_shape_models=str(out / 'jshape')))
    np.random.seed(0)
    tzoo.main(dict(zoo, path_out=str(out / 'tzoo'),
                   path_shape_models=str(out / 'cshape'), device='cpu'))
    return out


def test_shape_model_app(runs):
    """The ray signatures equal JAX's; the port's own pickles hold numpy
    only and reload as shape models of the port."""
    from pyimsegm_tpu_torch.apps import run_RG2Sp_estim_shape_models as app
    from pyimsegm_tpu_torch.apps.run_ovary_egg_segmentation import \
        load_shape_model
    jrays = np.load(runs / 'jshape' / app.NAME_NPZ)
    trays = np.load(runs / 'tshape' / app.NAME_NPZ)
    n_rays = int(np.ceil(360 / RAY_STEP))
    assert trays['rays'].shape == (N_SCENES * N_EGGS, n_rays)
    for key in ('rays', 'shifts'):
        np.testing.assert_allclose(trays[key], jrays[key], rtol=0, atol=1e-6)
    for name, shape_type in ((app.NAME_SINGLE, 'cdf'),
                             (app.NAME_MIXTURE, 'set_cdfs')):
        with open(runs / 'tshape' / name, 'rb') as fp:
            state = pickle.load(fp)
        assert state['name'] == shape_type
        assert all(isinstance(v, np.ndarray)
                   for v in state['model'].values())
        got_type, (model, tables) = load_shape_model(
            str(runs / 'tshape' / name), device='cpu')
        assert got_type == shape_type
        assert model.predict_proba(trays['rays'][:3]).shape[0] == 3
        table = np.asarray(tables if shape_type == 'cdf' else tables[0][1])
        assert table.shape[0] == n_rays
        assert np.isfinite(table).all()


@pytest.mark.parametrize('method', METHODS)
def test_zoo_method_matches_jax(runs, method):
    jpath = glob.glob(str(runs / 'jzoo' / '*' / method / 'slice_0.png'))
    tpath = glob.glob(str(runs / 'tzoo' / '*' / method / 'slice_0.png'))
    assert len(jpath) == len(tpath) == 1
    got, want = _png(tpath[0]), _png(jpath[0])
    _same_segm(got, want)
    assert got.max() == want.max()


def test_zoo_catches_nothing(runs):
    """No method took the app's catch: the log holds no failure."""
    log = glob.glob(str(runs / 'tzoo' / '*' / 'logging.txt'))
    assert len(log) == 1
    assert 'failed' not in open(log[0]).read()


def test_zoo_equals_library_calls(runs, ovary_dataset):
    """Two of the app's methods against the port's library on the same
    loaded inputs: the superpixel GraphCut with its shape term and GraphCut
    RG2Sp on the mixture model."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch.apps import common
    from pyimsegm_tpu_torch.apps import run_ovary_egg_segmentation as app
    from pyimsegm_tpu_torch.apps.run_center_candidate_training import \
        load_center_annotation
    from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
    root = ovary_dataset
    img, _ = common.load_image_by_type(str(root / 'image' / 'slice_0.png'))
    segm = _png(root / 'segm' / 'slice_0.png')
    centres = load_center_annotation(str(root / 'centers' / 'slice_0.csv'))
    slic = segment_slic_img2d(img, sp_size=ZOO_SP, relative_compact=0.3,
                              device='cpu')
    params = app.SEGM_PARAMS
    gc = rg.object_segmentation_graphcut_slic(
        slic, segm, centres, params['tab-proba_graphcut'], 1.,
        edge_coef=1., edge_type='model', coef_shape=0.1, device='cpu')
    np.testing.assert_array_equal(
        _png(glob.glob(str(runs / 'tzoo' / '*' / 'GC_slic-shape'
                           / 'slice_0.png'))[0]), gc[slic])
    shape_type, shape_model = app.load_shape_model(
        str(runs / 'cshape' / 'RG2SP_eggs_mixture-model.pkl'), 'cpu')
    labels = rg.region_growing_shape_slic_graphcut(
        slic, rg.compute_segm_prob_fg(slic, segm, params['tab-proba_RG2SP']),
        centres, shape_model, shape_type=shape_type,
        coef_shape=params['RG2SP-shape'],
        coef_pairwise=params['RG2SP-pairwise'],
        prob_label_trans=tuple(params['label_trans']),
        allow_obj_swap=params['RG2SP-swap'],
        dict_thresholds=rg.RG2SP_THRESHOLDS, nb_iter=50, device='cpu')
    np.testing.assert_array_equal(
        _png(glob.glob(str(runs / 'tzoo' / '*' / 'RG2SP_GC-mixture'
                           / 'slice_0.png'))[0]), labels[slic])


def test_zoo_snake_inputs_match_jax():
    """``simplify_segm_3cls`` equals JAX's, and ``morphsnakes_inputs``
    builds JAX's image, circles and step count."""
    from apps import run_ovary_egg_segmentation as jzoo
    from pyimsegm_tpu.ops import snakes as jsnakes
    from pyimsegm_tpu_torch.apps import run_ovary_egg_segmentation as tzoo
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    img, segm, centres = sample_ovary_scene((128, 160), 2, rand_seed=1)
    np.testing.assert_array_equal(tzoo.simplify_segm_3cls(segm),
                                  jzoo.simplify_segm_3cls(segm))
    image, masks, n_iter = tzoo.morphsnakes_inputs(img, centres)
    np.testing.assert_array_equal(image, np.asarray(img, float)[:, :, 0])
    np.testing.assert_array_equal(
        masks, np.asarray(jsnakes.circle_masks(image.shape, centres,
                                               radius=15)))
    assert n_iter == int(np.hypot(128, 160) / 2.0)
    _, box, n_box = tzoo.morphsnakes_inputs(img, centres, init_center=False,
                                            bb_dist=10, max_iter=20)
    assert box.shape == (1, 128, 160) and box[0].sum() == 108 * 140
    assert n_box == 20
