"""Cut individual annotated objects out of images.

Port of the JAX package's ``apps/run_cut_segmented_objects.py``, after the
reference's ``run_cut_segmented_objects.py``:
for each (annotation, image) pair, export one rotated/padded crop per
annotated object.

Example::

    python -m pyimsegm_tpu_torch.apps.run_cut_segmented_objects \
        --path_annot '.../annot_eggs/*.png' --path_image '.../image/*.jpg' \
        --path_out ./cut_images --padding 20
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_annot', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_image', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './cut_images', 'output folder')
    parser.add_argument('--padding', type=int, default=0)
    parser.add_argument('--mask', action='store_true', default=False,
                        help='fill background outside the object mask')
    parser.add_argument('--no_rotate', action='store_true', default=False)
    return common.parse_arg_params(parser, {})


def export_cut_objects(name, img, annot, path_out, padding, use_mask,
                       allow_rotate):
    """One crop per annotated object (`run_cut_segmented_objects.py:82-102`)."""
    for lb in np.unique(annot)[1:]:
        mask = (annot == lb).astype(int)
        if mask.sum() < 4:
            continue
        img_cut = data_io.cut_object(img, mask, padding, use_mask=use_mask,
                                     allow_rotate=allow_rotate)
        data_io.export_image(
            os.path.join(path_out, '%s_lb-%i' % (name, lb)),
            np.asarray(img_cut), stretch_range=False)


def main(params):
    df = data_io.find_files_match_names_across_dirs(
        [params['path_annot'], params['path_image']])
    os.makedirs(params['path_out'], exist_ok=True)
    for _, row in df.iterrows():
        annot, name = data_io.load_image_2d(row['path_1'])
        img, _ = data_io.load_image_2d(row['path_2'])
        export_cut_objects(name, np.asarray(img),
                           np.asarray(annot).astype(int),
                           params['path_out'], params['padding'],
                           params['mask'], not params['no_rotate'])
        logging.info('cut objects of "%s"', name)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
