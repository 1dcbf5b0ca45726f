"""Egg-center prediction: load classifier -> detect candidates -> cluster.

Port of the JAX package's ``apps/run_center_prediction.py``, after the
reference's ``run_center_prediction.py`` with the
clustering stage of `run_center_clustering.py` chained in: for each image +
segmentation, candidate points are classified and positives merged by DBSCAN;
per-image centre CSVs are written incrementally.

Example::

    python -m pyimsegm_tpu_torch.apps.run_center_prediction \
        --path_classif results/detect-centers-train_ovary/classifier_RandForest.pkl \
        --path_images '.../image/*.jpg' --path_segms '.../segm/*.png' \
        --path_out ./results
"""

import argparse
import logging
import os
import time

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import centers as ctr
from pyimsegm_tpu_torch.classification import load_classifier
from pyimsegm_tpu_torch.utils import data_io
from pyimsegm_tpu_torch.utils.experiments import append_final_stat

NAME_EXPERIMENT = 'detect-centers-predict'
FOLDER_POINTS = 'candidates'
FOLDER_CENTRES = 'centres'


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_classif', '', 'trained classifier pkl',
                        required=True)
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_segms', '', 'segmentation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--name', type=str, default='ovary')
    parser.add_argument('--visual', action='store_true', default=False)
    common.add_device_arg(parser, params.get('device', 'cuda'))
    return common.parse_arg_params(parser, params)


def main(params):
    t_start = time.time()
    path_out = common.setup_experiment(params, NAME_EXPERIMENT)
    for sub in (FOLDER_POINTS, FOLDER_CENTRES):
        os.makedirs(os.path.join(path_out, sub), exist_ok=True)
    device = params.get('device', 'cuda')
    classif = load_classifier(params['path_classif'], device=device)

    df_paths = data_io.find_files_match_names_across_dirs(
        [params['path_images'], params['path_segms']])
    import pandas as pd
    for _, row in df_paths.iterrows():
        img, name = common.load_image_by_type(row['path_1'], '2d_rgb')
        segm, _ = data_io.load_image_2d(row['path_2'])
        t0 = time.time()
        out = ctr.load_compute_detect_centers(
            img, np.asarray(segm).astype(int), classif, params,
            device=device)
        pd.DataFrame(out['candidates'], columns=['Y', 'X']).to_csv(
            os.path.join(path_out, FOLDER_POINTS, name + '.csv'))
        pd.DataFrame(out['centers'], columns=['Y', 'X']).to_csv(
            os.path.join(path_out, FOLDER_CENTRES, name + '.csv'))
        logging.info('image "%s": %i candidates -> %i centres (%.1fs)',
                     name, len(out['candidates']), len(out['centers']),
                     time.time() - t0)
        if params.get('visual'):
            import matplotlib.pyplot as plt
            from pyimsegm_tpu_torch.utils import drawing
            fig, ax = plt.subplots()
            drawing.draw_image_clusters_centers(
                ax, img[:, :, 0], out['centers'], points=out['candidates'],
                labels_centre=out['clust_labels'], segm=segm)
            fig.savefig(os.path.join(path_out, FOLDER_CENTRES,
                                     name + '_visual.png'))
            plt.close(fig)
    append_final_stat(path_out, params, {}, t_start)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(ctr.CENTER_PARAMS, **ctr.CLUSTER_PARAMS)))
