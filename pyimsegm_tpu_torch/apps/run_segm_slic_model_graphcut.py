"""Unsupervised segmentation experiment: SLIC + features + GMM + GraphCut.

Port of the JAX package's ``apps/run_segm_slic_model_graphcut.py``, after the
reference's ``run_segm_slic_model_graphcut.py``:
per-image model ("experiment_single_gmm") and/or group model
("experiment_group_gmm", model pickled for reuse), segmentations + soft
probabilities exported, ARS between the two variants reported, optional
background-on-boundary postprocessing and debug figures.

Example::

    python -m pyimsegm_tpu_torch.apps.run_segm_slic_model_graphcut \
        --path_predict_imgs 'data-images/drosophila_disc/image/img_[5-6].jpg' \
        --path_out ./results --nb_classes 3 --visual
"""

import argparse
import logging
import os
import pickle
import time

import numpy as np

from pyimsegm_tpu_torch import pipelines
from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.labeling import assume_bg_on_boundary
from pyimsegm_tpu_torch.models.class_model import (
    class_model_from_numpy, class_model_to_numpy)
from pyimsegm_tpu_torch.utils.experiments import append_final_stat
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

NAME_EXPERIMENT = 'experiment_segm-unSupervised'
#: default parameters (`run_segm_slic_model_graphcut.py:101-125`)
SEGM_PARAMS = {
    'name': 'imgDisk',
    'nb_classes': 3,
    'img_type': '2d_rgb',
    'slic_size': 35,
    'slic_regul': 0.2,
    'features': {'color': ['mean', 'std', 'energy']},
    'estim_model': 'GMM',
    'pca_coef': None,
    'gc_regul': 2.0,
    'gc_edge_type': 'model',
    'path_train_list': '',
    'path_predict_imgs': '',
    'path_out': './results',
    'device': 'cuda',
}
#: file name of the pickled group model (a dict of numpy arrays)
NAME_MODEL = 'model_estim_class.pkl'


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_train_list', params['path_train_list'],
                        'path to the list of images')
    common.add_path_arg(parser, 'path_predict_imgs',
                        params['path_predict_imgs'],
                        'path pattern to images to segment')
    common.add_path_arg(parser, 'path_out', params['path_out'],
                        'path to the output directory')
    common.add_path_arg(parser, 'path_config', '', 'path to YAML config')
    parser.add_argument('--name', type=str, default=params['name'])
    parser.add_argument('--img_type', type=str, default=params['img_type'],
                        choices=common.TYPES_LOAD_IMAGE)
    parser.add_argument('--nb_classes', type=int,
                        default=params['nb_classes'])
    parser.add_argument('--slic_size', type=int, default=params['slic_size'])
    parser.add_argument('--slic_regul', type=float,
                        default=params['slic_regul'])
    parser.add_argument('--gc_regul', type=float, default=params['gc_regul'])
    parser.add_argument('--visual', action='store_true', default=False)
    parser.add_argument('--unique', action='store_true', default=False)
    parser.add_argument('--run_groupGMM', action='store_true', default=True)
    common.add_device_arg(parser, params['device'])
    return common.parse_arg_params(parser, params)


def segment_image_independent(img, params):
    """Per-image unsupervised model (`experiment_single_gmm`, :451-475)."""
    segm, segm_soft = pipelines.pipe_color2d_slic_features_model_graphcut(
        img, params['nb_classes'], params['features'],
        sp_size=params['slic_size'], sp_regul=params['slic_regul'],
        pca_coef=params.get('pca_coef'), estim_model=params['estim_model'],
        gc_regul=params['gc_regul'], gc_edge_type=params['gc_edge_type'],
        device=params.get('device', 'cuda'))
    segm = assume_bg_on_boundary(segm, bg_label=0)
    return segm, segm_soft


def experiment_single_gmm(params, paths_img, path_out):
    dict_segms = {}
    for path_img in paths_img:
        img, name = common.load_image_by_type(path_img, params['img_type'])
        t0 = time.time()
        try:
            segm, soft = segment_image_independent(img, params)
        except Exception:
            # a failed image degrades to a zero segmentation and the batch
            # continues (`run_segm_slic_model_graphcut.py:353-370`)
            logging.exception('segmentation failed for "%s"', name)
            segm = np.zeros(img.shape[:2], int)
            soft = np.zeros(img.shape[:2] + (params['nb_classes'],))
        logging.info('single-model segm "%s" in %.1fs', name, time.time() - t0)
        common.export_segm(os.path.join(path_out, 'segm_single'), name, segm,
                           soft)
        if params.get('visual'):
            from pyimsegm_tpu_torch.utils import drawing
            fig = drawing.figure_image_segm_results(img, segm)
            fig.savefig(os.path.join(path_out, 'segm_single',
                                     name + '_visual.png'))
        dict_segms[name] = segm
    return dict_segms


def experiment_group_gmm(params, paths_img, path_out):
    """Group model over all images, pickled (`:476-508`, `:253-268`)."""
    imgs, names = [], []
    for path_img in paths_img:
        img, name = common.load_image_by_type(path_img, params['img_type'])
        imgs.append(img)
        names.append(name)
    model, _ = pipelines.estim_model_classes_group(
        imgs, params['nb_classes'], params['features'],
        sp_size=params['slic_size'], sp_regul=params['slic_regul'],
        pca_coef=params.get('pca_coef'), model_type=params['estim_model'],
        device=params.get('device', 'cuda'))
    save_class_model(os.path.join(path_out, NAME_MODEL), model)
    dict_segms = {}
    for img, name in zip(imgs, names):
        try:
            segm, soft = pipelines.segment_color2d_slic_features_model_graphcut(
                img, model, params['features'], sp_size=params['slic_size'],
                sp_regul=params['slic_regul'], gc_regul=params['gc_regul'],
                gc_edge_type=params['gc_edge_type'])
        except Exception:
            logging.exception('segmentation failed for "%s"', name)
            segm = np.zeros(img.shape[:2], int)
            soft = np.zeros(img.shape[:2] + (params['nb_classes'],))
        segm = assume_bg_on_boundary(segm, bg_label=0)
        common.export_segm(os.path.join(path_out, 'segm_group'), name, segm,
                           soft)
        if params.get('visual'):
            from pyimsegm_tpu_torch.utils import drawing
            fig = drawing.figure_image_segm_results(img, segm)
            fig.savefig(os.path.join(path_out, 'segm_group',
                                     name + '_visual.png'))
        dict_segms[name] = segm
    return dict_segms


def save_class_model(path_model, model):
    """Pickle a fitted :class:`ClassModel` as a dict of numpy arrays."""
    with open(path_model, 'wb') as fp:
        pickle.dump(class_model_to_numpy(model), fp)


def load_class_model(path_model, device='cuda'):
    """A :class:`ClassModel` on ``device`` from :func:`save_class_model`'s
    pickle."""
    with open(path_model, 'rb') as fp:
        return class_model_from_numpy(pickle.load(fp)).to(device)


def compare_segms_metric_ars(dict_segm_a, dict_segm_b, suffix=''):
    """ARS between two segmentation variants per image
    (`run_segm_slic_model_graphcut.py:430-448`)."""
    import pandas as pd
    rows = {}
    for name in dict_segm_a:
        if name not in dict_segm_b:
            continue
        ars = float(adjusted_rand_score(
            np.asarray(dict_segm_a[name]).ravel(),
            np.asarray(dict_segm_b[name]).ravel()))
        rows[name] = {'ARS' + suffix: ars}
    return pd.DataFrame.from_dict(rows, orient='index')


def main(params):
    t_start = time.time()
    path_out = common.setup_experiment(params, NAME_EXPERIMENT,
                                       stamp_unique=params.get('unique', False))
    paths_img = common.list_images(params['path_predict_imgs'])
    logging.info('found %i images', len(paths_img))

    dict_single = experiment_single_gmm(params, paths_img, path_out)
    stats = {}
    if params.get('run_groupGMM', True):
        dict_group = experiment_group_gmm(params, paths_img, path_out)
        df = compare_segms_metric_ars(dict_single, dict_group,
                                      suffix='_single-group')
        df.to_csv(os.path.join(path_out, 'metric_ARS.csv'))
        stats['ARS_mean'] = float(df.mean().iloc[0]) if len(df) else float('nan')
    append_final_stat(path_out, params, stats, t_start)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(SEGM_PARAMS)))
