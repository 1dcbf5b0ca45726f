"""Relabel annotation images by an explicit old->new label mapping.

Port of the JAX package's
``apps/handling_annotations/run_segm_annot_relabel.py``, after the reference's
``run_segm_annot_relabel.py``.

Example::

    python -m \
        pyimsegm_tpu_torch.apps.handling_annotations.run_segm_annot_relabel \
        --path_images './annots/*.png' --label_old 2 3 --label_new 1 1
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.labeling import relabel_by_dict
from pyimsegm_tpu_torch.utils import data_io


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', '', 'output folder (default: '
                        'in place)')
    parser.add_argument('--label_old', type=int, nargs='+', required=True)
    parser.add_argument('--label_new', type=int, nargs='+', required=True)
    return common.parse_arg_params(parser, {})


def relabel_folder(params):
    if len(params['label_old']) != len(params['label_new']):
        raise ValueError('label_old and label_new must have equal length')
    for path_img in sorted(glob.glob(params['path_images'])):
        img, name = data_io.load_image_2d(path_img)
        img = np.asarray(img).astype(int)
        # identity for unmapped labels, replacement for the requested pairs
        mapping = {int(lb): [int(lb)] for lb in np.unique(img)}
        for old, new in zip(params['label_old'], params['label_new']):
            mapping.get(old, []).clear()
            mapping.setdefault(new, []).append(old)
        out = relabel_by_dict(img, mapping)
        path_out = path_img if not params.get('path_out') else \
            os.path.join(params['path_out'], os.path.basename(path_img))
        if params.get('path_out'):
            os.makedirs(params['path_out'], exist_ok=True)
        data_io.io_imsave(path_out, np.asarray(out, np.uint8))
        logging.info('relabeled "%s"', name)


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    relabel_folder(arg_parse_params())
