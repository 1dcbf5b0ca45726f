"""Evaluate egg instance segmentations per method against annotation.

Port of the JAX package's ``apps/run_ovary_segm_evaluation.py``, after the
reference's ``run_ovary_segm_evaluation.py``:
for every method folder produced by ``run_ovary_egg_segmentation``, match
exported instance maps with the egg annotations, relabel instances to the
best-overlapping annotation object, and compute ARS / accuracy / P / R / F1.

Example::

    python -m pyimsegm_tpu_torch.apps.run_ovary_segm_evaluation \
        --path_segms 'results/ovary_egg-segmentation_ovary' \
        --path_annots '.../annot_eggs/*.png' --path_out ./results
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.labeling import relabel_max_overlap_unique
from pyimsegm_tpu_torch.utils import data_io
from pyimsegm_tpu_torch.utils.metrics import compute_classif_metrics

NAME_CSV = 'statistic_egg-segm_%s.csv'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_segms', '',
                        'experiment folder with per-method subfolders',
                        required=True)
    common.add_path_arg(parser, 'path_annots', '', 'egg annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    return common.parse_arg_params(parser, {})


def evaluate_method(path_method, params):
    import pandas as pd
    rows = {}
    for path_segm in sorted(glob.glob(os.path.join(path_method, '*.png'))):
        name = os.path.splitext(os.path.basename(path_segm))[0]
        matches = [p for p in glob.glob(params['path_annots']) if name in p]
        if not matches:
            continue
        segm = np.asarray(data_io.load_image_2d(path_segm)[0]).astype(int)
        annot = np.asarray(data_io.load_image_2d(matches[0])[0]).astype(int)
        segm = relabel_max_overlap_unique(annot, segm, keep_bg=True)
        m = compute_classif_metrics(annot.ravel(), segm.ravel())
        m.pop('confusion', None)
        rows[name] = m
    return pd.DataFrame.from_dict(rows, orient='index')


def main(params):
    os.makedirs(params['path_out'], exist_ok=True)
    methods = [d for d in sorted(os.listdir(params['path_segms']))
               if os.path.isdir(os.path.join(params['path_segms'], d))]
    summary = {}
    for method in methods:
        df = evaluate_method(os.path.join(params['path_segms'], method),
                             params)
        if not len(df):
            continue
        df.to_csv(os.path.join(params['path_out'], NAME_CSV % method))
        summary[method] = df.mean().to_dict()
        logging.info('method "%s": mean ARS=%.3f f1=%.3f', method,
                     summary[method].get('ARS', float('nan')),
                     summary[method].get('f1_macro', float('nan')))
    import pandas as pd
    df_sum = pd.DataFrame.from_dict(summary, orient='index')
    df_sum.to_csv(os.path.join(params['path_out'], NAME_CSV % 'SUMMARY'))
    return df_sum


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
