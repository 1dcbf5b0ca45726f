"""Cut eggs by matched ellipses and normalise size per development stage.

Port of the JAX package's ``apps/run_ellipse_cut_scale.py``, after the
reference's ``run_ellipse_cut_scale.py``: for each
row of the matched-ellipse table, rasterise the ellipse mask, cut the object
(rotated, masked) and resize to the per-stage median ellipse size.

Example::

    python -m pyimsegm_tpu_torch.apps.run_ellipse_cut_scale \
        --path_info results/info_ovary_images_ellipses.csv \
        --path_images '.../image' --path_out ./cut_stages
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import ellipse_fitting as ell_fit
from pyimsegm_tpu_torch.utils import data_io

COLUMNS_ELLIPSE = ['ellipse_xc', 'ellipse_yc', 'ellipse_a', 'ellipse_b',
                   'ellipse_theta']


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_info', '', 'matched-ellipse CSV',
                        required=True)
    common.add_path_arg(parser, 'path_images', '', 'image folder',
                        required=True)
    common.add_path_arg(parser, 'path_out', './cut_stages', 'output folder')
    return common.parse_arg_params(parser, {})


def _resize(img, size):
    from PIL import Image
    arr = np.asarray(img)
    if arr.max() <= 1.0:
        arr = (arr * 255).astype(np.uint8)
    im = Image.fromarray(arr.astype(np.uint8))
    im = im.resize((size[1], size[0]))
    return np.asarray(im)


def extract_ellipse_object(row, path_images, path_out, norm_size):
    """Ellipse-masked cut + resize (`run_ellipse_cut_scale.py:46-72`)."""
    name = os.path.splitext(os.path.basename(str(row['image_path'])))[0]
    candidates = sorted(glob.glob(os.path.join(path_images, name + '.*')))
    if not candidates:
        return None
    img, _ = data_io.load_image_2d(candidates[0])
    img = np.asarray(img)
    ell_params = [row[c] for c in COLUMNS_ELLIPSE]
    mask = ell_fit.add_overlap_ellipse(np.zeros(img.shape[:2], int),
                                       ell_params, 1)
    img_cut = data_io.cut_object(img, mask, 0, use_mask=True)
    img_norm = _resize(img_cut, norm_size)
    return data_io.export_image(os.path.join(path_out, name), img_norm,
                                stretch_range=False)


def main(params):
    import pandas as pd
    df = pd.read_csv(params['path_info'], index_col=0)
    df = df.dropna(subset=[c for c in COLUMNS_ELLIPSE if c in df.columns])
    os.makedirs(params['path_out'], exist_ok=True)
    groups = df.groupby('stage') if 'stage' in df.columns else [(0, df)]
    for stage, df_group in groups:
        norm_size = (int(np.median(df_group['ellipse_b'])) * 2,
                     int(np.median(df_group['ellipse_a'])) * 2)
        path_stage = os.path.join(params['path_out'], str(int(stage)))
        os.makedirs(path_stage, exist_ok=True)
        logging.info('stage %s: %i eggs, norm size %r', stage, len(df_group),
                     norm_size)
        for _, row in df_group.iterrows():
            extract_ellipse_object(row, params['path_images'], path_stage,
                                   norm_size)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
