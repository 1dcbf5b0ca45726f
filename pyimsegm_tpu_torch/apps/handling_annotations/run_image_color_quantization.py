"""Quantize RGB annotation images to their dominant colours.

Port of the JAX package's
``apps/handling_annotations/run_image_color_quantization.py``, after the reference's
``run_image_color_quantization.py``:
estimate the frequent colours over the image set, quantize each image to
the nearest palette colour (per-pixel or inpainted), overwrite in place or
into an output folder.

Example::

    python -m \
        pyimsegm_tpu_torch.apps.handling_annotations.run_image_color_quantization \
        --path_images './images/*.png' --px_threshold 0.01 --method position
"""

import argparse
import glob
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
    common.add_path_arg(parser, 'path_out', '', 'output folder (default: '
                        'overwrite in place)')
    parser.add_argument('--px_threshold', type=float, default=1e-3)
    parser.add_argument('--method', type=str, default='color',
                        choices=['color', 'position'])
    common.add_device_arg(parser)
    return common.parse_arg_params(parser, {})


def quantize_folder_images(params):
    paths = sorted(glob.glob(params['path_images']))
    colors = annot.group_images_frequent_colors(paths,
                                                params['px_threshold'])
    palette = list(colors.keys())
    logging.info('estimated %i palette colours', len(palette))
    for path_img in paths:
        img, name = data_io.load_image_2d(path_img)
        if params['method'] == 'position':
            img_q = annot.quantize_image_nearest_pixel(np.asarray(img),
                                                       palette)
        else:
            img_q = annot.quantize_image_nearest_color(
                np.asarray(img), palette, device=params.get('device', 'cuda'))
        path_out = path_img if not params.get('path_out') else \
            os.path.join(params['path_out'], os.path.basename(path_img))
        if params.get('path_out'):
            os.makedirs(params['path_out'], exist_ok=True)
        data_io.io_imsave(path_out, np.asarray(img_q, np.uint8))
        logging.info('quantized "%s"', name)
    return paths


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    quantize_folder_images(arg_parse_params())
