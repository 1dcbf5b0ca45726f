"""Cluster detected centre candidates with DBSCAN.

Port of the JAX package's ``apps/run_center_clustering.py``, after the
reference's ``run_center_clustering.py``: loads
per-image candidate CSVs, merges them into final centres by density
clustering, exports centre CSVs + visualisations.

Example::

    python -m pyimsegm_tpu_torch.apps.run_center_clustering \
        --path_points 'results/detect-centers-predict_ovary/candidates/*.csv' \
        --path_images '.../image/*.jpg' --path_out ./results
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.centers import (CLUSTER_PARAMS,
                                        cluster_center_candidates)
from pyimsegm_tpu_torch.utils import data_io

FOLDER_CENTERS = 'centres_clustered'


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_points', '', 'candidate CSV pattern',
                        required=True)
    common.add_path_arg(parser, 'path_images', '', 'optional image pattern')
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--DBSCAN_max_dist', type=float,
                        default=params['DBSCAN_max_dist'])
    parser.add_argument('--DBSCAN_min_samples', type=int,
                        default=params['DBSCAN_min_samples'])
    parser.add_argument('--visual', action='store_true', default=False)
    common.add_device_arg(parser, params.get('device', 'cuda'))
    return common.parse_arg_params(parser, params)


def main(params):
    import glob
    import pandas as pd
    path_dir = os.path.join(params['path_out'], FOLDER_CENTERS)
    os.makedirs(path_dir, exist_ok=True)
    for path_csv in sorted(glob.glob(params['path_points'])):
        name = os.path.splitext(os.path.basename(path_csv))[0]
        df = pd.read_csv(path_csv, index_col=0)
        points = df[['Y', 'X']].values if len(df) else np.zeros((0, 2))
        centers, labels = cluster_center_candidates(
            points, max_dist=params['DBSCAN_max_dist'],
            min_samples=params['DBSCAN_min_samples'],
            device=params.get('device', 'cuda'))
        pd.DataFrame(centers, columns=['Y', 'X']).to_csv(
            os.path.join(path_dir, name + '.csv'))
        logging.info('"%s": %i candidates -> %i centres', name, len(points),
                     len(centers))
        if params.get('visual') and params.get('path_images'):
            matches = [p for p in glob.glob(params['path_images'])
                       if name in p]
            if matches:
                import matplotlib.pyplot as plt
                from pyimsegm_tpu_torch.utils import drawing
                img, _ = data_io.load_image_2d(matches[0])
                fig, ax = plt.subplots()
                drawing.draw_image_clusters_centers(
                    ax, np.asarray(img)[..., 0] if np.asarray(img).ndim == 3
                    else img, centers, points=points, labels_centre=labels)
                fig.savefig(os.path.join(path_dir, name + '_visual.png'))
                plt.close(fig)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(CLUSTER_PARAMS)))
