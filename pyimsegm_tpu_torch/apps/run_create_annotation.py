"""Create center annotations (masks and CSVs) from egg annotations.

Port of the JAX package's ``apps/run_create_annotation.py``, after the
reference's ``run_create_annotation.py``: derive
per-egg centre points from instance annotations, draw the three-level centre
annotation (background / near-centre band / centre disk) and export both the
mask and the points CSV.

Example::

    python -m pyimsegm_tpu_torch.apps.run_create_annotation \
        --path_annots '.../annot_eggs/*.png' --path_out ./center_annots
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io

#: radii for the centre disk and the uncertain ring (reference center_levels)
RADIUS_CENTER = 25
RADIUS_RING = 50


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_annots', '', 'egg annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './center_annots',
                        'output folder')
    parser.add_argument('--radius_center', type=int, default=RADIUS_CENTER)
    parser.add_argument('--radius_ring', type=int, default=RADIUS_RING)
    return common.parse_arg_params(parser, {})


def main(params):
    import pandas as pd
    from scipy import ndimage
    os.makedirs(params['path_out'], exist_ok=True)
    for path_annot in sorted(glob.glob(params['path_annots'])):
        annot, name = data_io.load_image_2d(path_annot)
        annot = np.asarray(annot).astype(int)
        labels = np.unique(annot)[1:]
        centers = [ndimage.center_of_mass(annot == lb) for lb in labels]
        # levels: 1 = inside egg, 3 = centre disk, 2 = uncertain ring
        mask = np.zeros(annot.shape, dtype=np.uint8)
        mask[annot > 0] = 1
        yy, xx = np.mgrid[:annot.shape[0], :annot.shape[1]]
        for cy, cx in centers:
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[d2 <= params['radius_ring'] ** 2] = 2
        for cy, cx in centers:
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[d2 <= params['radius_center'] ** 2] = 3
        data_io.export_image(os.path.join(params['path_out'], name), mask,
                             stretch_range=False)
        pd.DataFrame([(cx, cy) for cy, cx in centers],
                     columns=['X', 'Y']).to_csv(
            os.path.join(params['path_out'], name + '.csv'))
        logging.info('annotation "%s": %i centres', name, len(centers))
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
