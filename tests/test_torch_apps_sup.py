"""The port's supervised segmentation app
(``pyimsegm_tpu_torch.apps.run_segm_slic_classif_graphcut``) against the
JAX package's app on the same files, on the CPU, on ``tests/test_apps.py``'s
tiny dataset with image 0's annotation RGB-coded, the YAML config merged
over the CLI defaults and leave-one-image-out on.

The JAX app runs once in a module fixture (its forest compiles for each
training set: ~70 s).  Bars: every exported map has ARS >= 0.98 against
JAX's and >= 0.999 of its labels equal (the forests are random fits in
both packages; on bands this clear both find them); the CSVs have JAX's
columns by name, scores within 0.02; the LPO accuracy above 0.9.  The
saved classifier reloads and segments each image to the exported maps
exactly."""

import argparse
import os
import sys

import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_apps_segm import (NAMES, _png, _same_csv,  # noqa: E402
                                  _same_segm, tiny_dataset)  # noqa: F401

from torch_threads import one_torch_thread  # noqa: F401,E402

#: the app's YAML config (``tests/test_apps.py``'s)
SUP_CFG = {'name': 'cfgwins', 'img_type': '2d_rgb', 'slic_size': 8,
           'slic_regul': 0.3, 'features': {'color': ['mean', 'std']},
           'nb_classif_search': 1, 'gc_regul': 1.0, 'run_LPO': True}


def _merged_sup_params(app, common, data, path_cfg, out):
    """``tests/test_apps.py``'s merge: the YAML config outranks the CLI
    defaults, an absent flag keeps its default."""
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', str(data / 'image' / '*.jpg'),
                        'imgs')
    common.add_path_arg(parser, 'path_annots', str(data / 'annot' / '*.png'),
                        'annots')
    common.add_path_arg(parser, 'path_config', str(path_cfg), 'cfg')
    common.add_path_arg(parser, 'path_out', str(out), 'out')
    parser.add_argument('--slic_size', type=int,
                        default=app.SEGM_PARAMS['slic_size'])
    old_argv = sys.argv
    sys.argv = ['app']
    try:
        return common.parse_arg_params(parser, dict(app.SEGM_PARAMS))
    finally:
        sys.argv = old_argv


@pytest.fixture(scope='module')
def runs(tiny_dataset, tmp_path_factory):
    """JAX's app and the port's on the same files, each once."""
    from apps import common as jcommon
    from apps import run_segm_slic_classif_graphcut as jsup
    from pyimsegm_tpu_torch.apps import common as tcommon
    from pyimsegm_tpu_torch.apps import run_segm_slic_classif_graphcut as tsup

    _, rgb = tiny_dataset
    out = tmp_path_factory.mktemp('runs')
    path_cfg = out / 'cfg.yml'
    path_cfg.write_text(yaml.safe_dump(SUP_CFG))
    merged = []
    for pkg, app, common in (('jax', jsup, jcommon),
                             ('torch', tsup, tcommon)):
        params = _merged_sup_params(app, common, rgb, path_cfg, out / pkg)
        merged.append(dict(params))
        if pkg == 'torch':
            params['device'] = 'cpu'
        app.main(params)
    return {'sup': tuple(out / pkg / 'experiment_segm-Supervised_cfgwins'
                         for pkg in ('jax', 'torch')),
            'sup_params': merged}


def test_supervised_app_matches_jax(runs):
    """The YAML merge as JAX's app does it, then the exported GC and argmax
    maps, their statistics and the LPO table."""
    jparams, tparams = runs['sup_params']
    assert {k: v for k, v in tparams.items() if k != 'path_out'} == \
        {k: v for k, v in dict(jparams, device='cuda').items()
         if k != 'path_out'}
    assert tparams['slic_size'] == 8 and tparams['name'] == 'cfgwins'
    jdir, tdir = runs['sup']
    for sub in ('segm_graphcut', 'segm_argmax'):
        for name in NAMES:
            _same_segm(_png(tdir / sub / (name + '.png')),
                       _png(jdir / sub / (name + '.png')))
    for csv in ('stat_segm_graphcut.csv', 'stat_segm_argmax.csv'):
        _same_csv(jdir / csv, tdir / csv)
    _, df = _same_csv(jdir / 'stat_LPO.csv', tdir / 'stat_LPO.csv')
    assert len(df) == 2 and (df['GC_accuracy'] > 0.9).all()
    assert (tdir / 'classifier_RandForest.pkl').exists()


def test_supervised_app_equals_library_calls(runs, tiny_dataset):
    """The saved classifier reloads and segments each image to the exported
    GC and argmax maps."""
    from pyimsegm_tpu_torch import classification
    from pyimsegm_tpu_torch.apps import common
    from pyimsegm_tpu_torch.apps import run_segm_slic_classif_graphcut as app
    _, tdir = runs['sup']
    params = dict(app.SEGM_PARAMS, **SUP_CFG)
    clf = classification.load_classifier(
        str(tdir / 'classifier_RandForest.pkl'), device='cpu')
    for name in NAMES:
        img, _ = common.load_image_by_type(
            str(tiny_dataset[1] / 'image' / (name + '.jpg')))
        segm_gc, segm_am = app.segment_with_classifier(img, clf, params)
        np.testing.assert_array_equal(
            _png(tdir / 'segm_graphcut' / (name + '.png')), segm_gc)
        np.testing.assert_array_equal(
            _png(tdir / 'segm_argmax' / (name + '.png')), segm_am)
