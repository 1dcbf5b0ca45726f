"""Normalise egg orientation by density / template correlation swap.

Port of the JAX package's ``apps/run_egg_swap_orientation.py``, after the
reference's ``run_egg_swap_orientation.py``:
decide per cut-out egg image whether to rotate it 180 degrees, either by
comparing front/back intensity density or by correlation with the group
median template.

Example::

    python -m pyimsegm_tpu_torch.apps.run_egg_swap_orientation \
        --path_images './cut_stages/2/*.png' --path_out ./swapped
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io

IMAGE_CHANNEL = 0
SWAP_CONDITION = 'cc'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './swapped', 'output folder')
    parser.add_argument('--swap_type', type=str, default=SWAP_CONDITION,
                        choices=['cc', 'density'])
    return common.parse_arg_params(parser, {})


def correlation_coefficient(patch1, patch2):
    product = np.mean((patch1 - patch1.mean()) * (patch2 - patch2.mean()))
    stds = patch1.std() * patch2.std()
    return 0 if stds == 0 else product / stds


def condition_swap_density(img):
    """Front/back thirds intensity balance
    (`run_egg_swap_orientation.py:65-75`)."""
    part = int(img.shape[1] / 3)
    ch = img[:, :, IMAGE_CHANNEL] if img.ndim == 3 else img
    sel = ch > np.min(ch)
    norm_val = np.mean(ch[sel])
    val_left = np.sum(ch[:, :part] > norm_val)
    val_right = np.sum(ch[:, -part:] > norm_val)
    return (val_left / max(float(val_right), 1e-9)) > 1.0


def condition_swap_correl(img, template):
    ch = img[:, :, IMAGE_CHANNEL] if img.ndim == 3 else img
    cc = correlation_coefficient(ch, template)
    cc_swap = correlation_coefficient(ch[::-1, ::-1], template)
    return cc < cc_swap


def compute_mean_image(paths):
    """Median template over equally-cropped images
    (`run_egg_swap_orientation.py:92-99`)."""
    imgs = []
    for p in paths:
        im, _ = data_io.load_image_2d(p)
        im = np.asarray(im)
        imgs.append(im[:, :, IMAGE_CHANNEL] if im.ndim == 3 else im)
    min_size = np.min([im.shape for im in imgs], axis=0)
    imgs = [im[:min_size[0], :min_size[1]] for im in imgs]
    return np.median(imgs, axis=0)


def main(params):
    paths = sorted(glob.glob(params['path_images']))
    os.makedirs(params['path_out'], exist_ok=True)
    template = compute_mean_image(paths) if params['swap_type'] == 'cc' \
        else None
    nb_swapped = 0
    for path_img in paths:
        img, name = data_io.load_image_2d(path_img)
        img = np.asarray(img)
        if template is not None:
            crop = img[:template.shape[0], :template.shape[1]]
            b_swap = condition_swap_correl(crop, template)
        else:
            b_swap = condition_swap_density(img)
        if b_swap:
            img = img[::-1, ::-1] if img.ndim == 2 else img[::-1, ::-1, :]
            nb_swapped += 1
        data_io.export_image(os.path.join(params['path_out'], name), img,
                             stretch_range=False)
    logging.info('swapped %i of %i images', nb_swapped, len(paths))
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
