"""Export image+segmentation overlap visualisations for a whole folder.

Port of the JAX package's
``apps/handling_annotations/run_overlap_images_segms.py``, after the reference's
``run_overlap_images_segms.py``.

Example::

    python -m \
        pyimsegm_tpu_torch.apps.handling_annotations.run_overlap_images_segms \
        --path_images '.../image/*.jpg' --path_segms '.../segm/*.png' \
        --path_out ./overlaps
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io, drawing


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_segms', '', 'segmentation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './overlaps', 'output folder')
    parser.add_argument('--overlap', type=float, default=0.2)
    return common.parse_arg_params(parser, {})


def export_overlaps(params):
    import matplotlib.pyplot as plt
    df = data_io.find_files_match_names_across_dirs(
        [params['path_images'], params['path_segms']])
    os.makedirs(params['path_out'], exist_ok=True)
    for _, row in df.iterrows():
        img, name = data_io.load_image_2d(row['path_1'])
        segm, _ = data_io.load_image_2d(row['path_2'])
        fig = drawing.figure_image_segm_results(
            np.asarray(img), np.asarray(segm).astype(int),
            mid_labels_alpha=params['overlap'])
        fig.savefig(os.path.join(params['path_out'], name + '.png'))
        plt.close(fig)
        logging.info('exported overlap "%s"', name)
    return df


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    export_overlaps(arg_parse_params())
