"""Inpaint a label in annotation images from the surrounding labels.

Port of the JAX package's
``apps/handling_annotations/run_segm_annot_inpaint.py``, after the reference's
``run_segm_annot_inpaint.py``: pixels of
the selected label are replaced by their nearest other-label value.

Example::

    python -m \
        pyimsegm_tpu_torch.apps.handling_annotations.run_segm_annot_inpaint \
        --path_images './annots/*.png' --label 0
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.annotation import image_inpaint_pixels
from pyimsegm_tpu_torch.utils import data_io


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', '', 'output folder (default: '
                        'in place)')
    parser.add_argument('--label', type=int, default=-1,
                        help='label to be inpainted')
    return common.parse_arg_params(parser, {})


def inpaint_folder(params):
    for path_img in sorted(glob.glob(params['path_images'])):
        img, name = data_io.load_image_2d(path_img)
        img = np.asarray(img).astype(int)
        valid = img != params['label']
        if valid.all():
            continue
        out = image_inpaint_pixels(img, valid)
        path_out = path_img if not params.get('path_out') else \
            os.path.join(params['path_out'], os.path.basename(path_img))
        if params.get('path_out'):
            os.makedirs(params['path_out'], exist_ok=True)
        data_io.io_imsave(path_out, np.asarray(out, np.uint8))
        logging.info('inpainted "%s"', name)


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    inpaint_folder(arg_parse_params())
