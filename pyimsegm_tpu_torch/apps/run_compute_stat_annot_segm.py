"""Annotation-vs-segmentation statistics + visual overlaps.

Port of the JAX package's ``apps/run_compute_stat_annot_segm.py``, after the
reference's ``run_compute_stat_annot_segm.py``:
pairs annotation and segmentation folders by name, computes the metric set
(ARS, accuracy, confusion, P/R/F1 macro+weighted) per image and in total,
exports overlap figures.

Example::

    python -m pyimsegm_tpu_torch.apps.run_compute_stat_annot_segm \
        --path_annot '.../annot_struct/*.png' --path_segm '.../segm/*.png' \
        --path_out ./results
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io
from pyimsegm_tpu_torch.utils.metrics import compute_classif_metrics

NAME_CSV_STAT = 'statistic_annot-segm.csv'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_annot', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_segm', '', 'segmentation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_img', '', 'optional image pattern')
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--drop_labels', type=int, nargs='*', default=[])
    parser.add_argument('--visual', action='store_true', default=False)
    return common.parse_arg_params(parser, {})


def stat_annot_segm(params):
    import pandas as pd
    patterns = [params['path_annot'], params['path_segm']]
    if params.get('path_img'):
        patterns.append(params['path_img'])
    df_paths = data_io.find_files_match_names_across_dirs(patterns)
    os.makedirs(params['path_out'], exist_ok=True)
    rows = {}
    for _, row in df_paths.iterrows():
        annot, name = data_io.load_image_2d(row['path_1'])
        segm, _ = data_io.load_image_2d(row['path_2'])
        annot = np.asarray(annot).astype(int)
        segm = np.asarray(segm).astype(int)
        # RGB-coded annotations: compare on the first channel
        # (`run_segm_slic_model_graphcut.py:225-228` semantics, no relabel so
        # the label identities still line up with the segmentation)
        if annot.ndim == 3:
            annot = annot[:, :, 0]
        if segm.ndim == 3:
            segm = segm[:, :, 0]
        keep = ~np.isin(annot, params.get('drop_labels', []))
        rows[name] = compute_classif_metrics(annot[keep], segm[keep])
        if params.get('visual'):
            from pyimsegm_tpu_torch.utils import drawing
            img = None
            if 'path_3' in row and isinstance(row.get('path_3'), str):
                img, _ = data_io.load_image_2d(row['path_3'])
            fig = drawing.figure_overlap_annot_segm_image(
                annot, segm, img, drop_labels=params.get('drop_labels'))
            fig.savefig(os.path.join(params['path_out'],
                                     name + '_overlap.png'))
    df = pd.DataFrame.from_dict(rows, orient='index')
    df.to_csv(os.path.join(params['path_out'], NAME_CSV_STAT))
    logging.info('mean metrics:\n%s',
                 df.drop(columns=['confusion'], errors='ignore').mean())
    return df


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    stat_annot_segm(arg_parse_params())
