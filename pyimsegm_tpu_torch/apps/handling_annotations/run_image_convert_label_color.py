"""Convert between label maps and colour annotations (both directions).

Port of the JAX package's
``apps/handling_annotations/run_image_convert_label_color.py``, after the reference's
``run_image_convert_label_color.py``:
label image -> RGB via a colour LUT (JSON), or RGB annotation -> labels.

Example::

    python -m \
        pyimsegm_tpu_torch.apps.handling_annotations.run_image_convert_label_color \
        --path_images './annots/*.png' --path_out ./converted \
        --path_colors ./colors.json
"""

import argparse
import glob
import json
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import annotation as annot
from pyimsegm_tpu_torch.utils import data_io


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './converted', 'output folder')
    common.add_path_arg(parser, 'path_colors', '', 'JSON with label->color '
                        'LUT (exported on labels->colors direction)')
    parser.add_argument('--direction', type=str, default='auto',
                        choices=['auto', 'labels2colors', 'colors2labels'])
    return common.parse_arg_params(parser, {})


def convert_folder_images(params):
    paths = sorted(glob.glob(params['path_images']))
    os.makedirs(params['path_out'], exist_ok=True)
    lut = None
    if params.get('path_colors') and os.path.isfile(params['path_colors']):
        with open(params['path_colors']) as fp:
            lut = {int(k): tuple(v) for k, v in json.load(fp).items()}
    for path_img in paths:
        img, name = data_io.load_image_2d(path_img)
        img = np.asarray(img)
        direction = params['direction']
        if direction == 'auto':
            direction = 'labels2colors' if img.ndim == 2 else 'colors2labels'
        if direction == 'labels2colors':
            lut = lut or {lb: annot.DICT_COLOURS[lb % len(annot.DICT_COLOURS)]
                          for lb in np.unique(img)}
            out = annot.convert_img_labels_to_colors(img.astype(int), lut)
            out = np.asarray(out, np.uint8)
        else:
            if lut is None:
                palette = list(annot.image_frequent_colors(img).keys())
                lut = {i: c for i, c in enumerate(palette)}
            out = annot.convert_img_colors_to_labels(img, lut)
            out = np.asarray(out, np.uint8)
        data_io.io_imsave(os.path.join(params['path_out'],
                                       os.path.basename(path_img)), out)
        logging.info('converted "%s" (%s)', name, direction)
    if lut is not None:
        with open(os.path.join(params['path_out'], 'colors.json'), 'w') as fp:
            json.dump({str(k): list(map(int, np.ravel(v)))
                       for k, v in lut.items()}, fp)
    return paths


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    convert_folder_images(arg_parse_params())
