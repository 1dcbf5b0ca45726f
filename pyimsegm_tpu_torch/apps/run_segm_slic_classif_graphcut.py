"""Supervised segmentation experiment: SLIC + features + classifier + GraphCut.

Port of the JAX package's ``apps/run_segm_slic_classif_graphcut.py``, after the
reference's ``run_segm_slic_classif_graphcut.py``:
image/annotation pairs -> superpixel training set (purity-filtered labels) ->
classifier with randomised search -> prediction of all images with both the
GraphCut and plain-argmax variants -> per-image quality stats, plus
leave-P-images-out cross-validation ("experiment_lpo", `:527-583`).

Example::

    python -m pyimsegm_tpu_torch.apps.run_segm_slic_classif_graphcut \
        --path_images 'data-images/drosophila_ovary_slice/image/*.jpg' \
        --path_annots 'data-images/drosophila_ovary_slice/annot_struct/*.png' \
        --path_out ./results
"""

import argparse
import logging
import os
import time

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import classification, labeling, pipelines
from pyimsegm_tpu_torch.utils.experiments import append_final_stat
from pyimsegm_tpu_torch.utils.metrics import compute_classif_metrics

NAME_EXPERIMENT = 'experiment_segm-Supervised'
#: default parameters (`run_segm_slic_classif_graphcut.py:88-120`)
SEGM_PARAMS = {
    'name': 'ovary',
    'img_type': '2d_split',
    'slic_size': 35,
    'slic_regul': 0.3,
    'features': {'color': ['mean', 'std', 'energy'],
                 'tLM_short': ['mean']},
    'label_purity': 0.95,
    'balance': 'unique',
    'classif': 'RandForest',
    'nb_classif_search': 5,
    'pca_coef': None,
    'gc_regul': 5.0,
    'gc_edge_type': 'model',
    'cross_val': 0.1,
    'run_LPO': True,
    'path_images': '',
    'path_annots': '',
    'path_out': './results',
    'device': 'cuda',
}


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', params['path_images'],
                        'path pattern to images')
    common.add_path_arg(parser, 'path_annots', params['path_annots'],
                        'path pattern to annotations')
    common.add_path_arg(parser, 'path_out', params['path_out'],
                        'path to the output directory')
    common.add_path_arg(parser, 'path_config', '', 'path to YAML config')
    parser.add_argument('--name', type=str, default=params['name'])
    parser.add_argument('--img_type', type=str, default=params['img_type'],
                        choices=common.TYPES_LOAD_IMAGE)
    parser.add_argument('--classif', type=str, default=params['classif'])
    parser.add_argument('--slic_size', type=int, default=params['slic_size'])
    parser.add_argument('--slic_regul', type=float,
                        default=params['slic_regul'])
    parser.add_argument('--gc_regul', type=float, default=params['gc_regul'])
    parser.add_argument('--nb_classif_search', type=int,
                        default=params['nb_classif_search'])
    parser.add_argument('--visual', action='store_true', default=False)
    parser.add_argument('--unique', action='store_true', default=False)
    common.add_device_arg(parser, params['device'])
    return common.parse_arg_params(parser, params)


def load_dataset(params):
    paths_img, paths_annot = common.find_images_annots(
        params['path_images'], params['path_annots'])
    imgs, annots, names = [], [], []
    for p_img, p_annot in zip(paths_img, paths_annot):
        img, name = common.load_image_by_type(p_img, params['img_type'])
        annot, _ = common.load_annot_2d(p_annot)
        imgs.append(img)
        annots.append(annot)
        names.append(name)
    return imgs, annots, names


def segment_with_classifier(img, classif, params):
    """Predict one image with GC and argmax variants
    (`run_segm_slic_classif_graphcut.py:431-525`) through the pipeline's
    classifier branch (grid fast path); the argmax variant reuses the
    branch's SLIC + proba via the debug hook."""
    dbg = {}
    segm_gc, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
        img, classif, params['features'], sp_size=params['slic_size'],
        sp_regul=params['slic_regul'], gc_regul=params['gc_regul'],
        gc_edge_type=params['gc_edge_type'], debug_visual=dbg)
    segm_argmax = np.asarray(classif.classes_)[
        np.argmax(dbg['proba'], axis=1)][dbg['slic']]
    return segm_gc, segm_argmax


def evaluate_segms(names, annots, dict_segms, path_out, suffix):
    import pandas as pd
    rows = {}
    for name, annot in zip(names, annots):
        if name not in dict_segms:
            continue
        rows[name] = compute_classif_metrics(annot.ravel(),
                                             dict_segms[name].ravel())
    df = pd.DataFrame.from_dict(rows, orient='index')
    df.to_csv(os.path.join(path_out, 'stat_segm%s.csv' % suffix))
    return df


def experiment_lpo(imgs, annots, names, params, path_out, nb_hold_out=1):
    """Leave-P-images-out CV (`run_segm_slic_classif_graphcut.py:527-583`)."""
    import pandas as pd
    cv = classification.CrossValidate(len(imgs), nb_hold_out)
    rows = {}
    for train_idx, test_idx in cv:
        classif, _, _, _ = pipelines.train_classif_color2d_slic_features(
            [imgs[i] for i in train_idx], [annots[i] for i in train_idx],
            params['features'], sp_size=params['slic_size'],
            sp_regul=params['slic_regul'], clf_name=params['classif'],
            label_purity=params['label_purity'],
            feature_balance=params['balance'],
            nb_classif_search=params['nb_classif_search'],
            device=params.get('device', 'cuda'))
        for i in test_idx:
            segm_gc, segm_am = segment_with_classifier(imgs[i], classif,
                                                       params)
            m_gc = compute_classif_metrics(annots[i].ravel(), segm_gc.ravel())
            m_am = compute_classif_metrics(annots[i].ravel(), segm_am.ravel())
            rows[names[i]] = {('GC_' + k): v for k, v in m_gc.items()}
            rows[names[i]].update({('argmax_' + k): v
                                   for k, v in m_am.items()})
    df = pd.DataFrame.from_dict(rows, orient='index')
    df.to_csv(os.path.join(path_out, 'stat_LPO.csv'))
    return df


def main(params):
    t_start = time.time()
    path_out = common.setup_experiment(params, NAME_EXPERIMENT,
                                       stamp_unique=params.get('unique', False))
    imgs, annots, names = load_dataset(params)
    logging.info('loaded %i image/annot pairs', len(imgs))

    classif, _, _, _ = pipelines.train_classif_color2d_slic_features(
        imgs, annots, params['features'], sp_size=params['slic_size'],
        sp_regul=params['slic_regul'], clf_name=params['classif'],
        label_purity=params['label_purity'], feature_balance=params['balance'],
        nb_classif_search=params['nb_classif_search'],
        pca_coef=params.get('pca_coef'), device=params.get('device', 'cuda'))
    classification.save_classifier(path_out, classif, params['classif'])

    dict_gc, dict_am = {}, {}
    for img, name in zip(imgs, names):
        segm_gc, segm_am = segment_with_classifier(img, classif, params)
        dict_gc[name], dict_am[name] = segm_gc, segm_am
        common.export_segm(os.path.join(path_out, 'segm_graphcut'), name,
                           segm_gc)
        common.export_segm(os.path.join(path_out, 'segm_argmax'), name,
                           segm_am)
        if params.get('visual'):
            from pyimsegm_tpu_torch.utils import drawing
            fig = drawing.figure_image_segm_results(img, segm_gc)
            fig.savefig(os.path.join(path_out, 'segm_graphcut',
                                     name + '_visual.png'))

    df_gc = evaluate_segms(names, annots, dict_gc, path_out, '_graphcut')
    evaluate_segms(names, annots, dict_am, path_out, '_argmax')

    stats = {'mean_ARS_graphcut': float(df_gc['ARS'].mean())
             if 'ARS' in df_gc else float('nan')}
    if params.get('run_LPO', True) and len(imgs) > 1:
        df_lpo = experiment_lpo(imgs, annots, names, params, path_out)
        if 'GC_ARS' in df_lpo:
            stats['LPO_mean_ARS_graphcut'] = float(df_lpo['GC_ARS'].mean())
    append_final_stat(path_out, params, stats, t_start)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(SEGM_PARAMS)))
