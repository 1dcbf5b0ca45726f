"""Superpixel quality evaluation: boundary distance vs annotation.

Port of the JAX package's ``apps/run_eval_superpixels.py``, after the
reference's ``run_eval_superpixels.py``: run SLIC
with given size/regularisation over images and measure the distance between
annotation boundaries and the nearest superpixel boundary.

Example::

    python -m pyimsegm_tpu_torch.apps.run_eval_superpixels \
        --path_images '.../image/*.jpg' --path_segms '.../annot_struct/*.png' \
        --path_out ./results --slic_size 35 --slic_regul 0.3
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.labeling import compute_boundary_distances
from pyimsegm_tpu_torch.ops.slic import segment_slic_img2d
from pyimsegm_tpu_torch.utils import data_io

NAME_CSV = 'statistic_superpixel-boundary.csv'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_segms', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--img_type', type=str, default='2d_rgb',
                        choices=common.TYPES_LOAD_IMAGE)
    parser.add_argument('--slic_size', type=int, default=35)
    parser.add_argument('--slic_regul', type=float, default=0.3)
    parser.add_argument('--visual', action='store_true', default=False)
    common.add_device_arg(parser)
    return common.parse_arg_params(parser, {})


def compute_boundary_distance(params):
    """Per-image mean/std of annotation->superpixel boundary distance
    (`run_eval_superpixels.py:108-140`)."""
    import pandas as pd
    df_paths = data_io.find_files_match_names_across_dirs(
        [params['path_images'], params['path_segms']])
    os.makedirs(params['path_out'], exist_ok=True)
    rows = {}
    for _, row in df_paths.iterrows():
        img, name = common.load_image_by_type(row['path_1'],
                                              params['img_type'])
        annot, _ = common.load_annot_2d(row['path_2'])
        slic = np.asarray(segment_slic_img2d(
            img, sp_size=params['slic_size'],
            relative_compact=params['slic_regul'],
            device=params.get('device', 'cuda')))
        _points, dists = compute_boundary_distances(
            np.asarray(annot).astype(int), slic)
        rows[name] = {'mean': float(np.mean(dists)),
                      'std': float(np.std(dists)),
                      'max': float(np.max(dists))}
        if params.get('visual'):
            from pyimsegm_tpu_torch.utils import drawing
            fig = drawing.figure_segm_boundary_dist(annot, slic)
            fig.savefig(os.path.join(params['path_out'], name + '_bdist.png'))
    df = pd.DataFrame.from_dict(rows, orient='index')
    df.to_csv(os.path.join(params['path_out'], NAME_CSV))
    logging.info('boundary stats:\n%s', df.mean())
    return df


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    compute_boundary_distance(arg_parse_params())
