"""Evaluate detected centres against annotated egg centres.

Port of the JAX package's ``apps/run_center_evaluation.py``, after the
reference's ``run_center_evaluation.py``:
matches per-image detected-centre CSVs with annotation (center CSVs or egg
annotation masks), computes TP/FP/FN + precision/recall/F1 within a distance
tolerance, and writes the summary CSV.

Example::

    python -m pyimsegm_tpu_torch.apps.run_center_evaluation \
        --path_centers 'results/detect-centers-predict_ovary/centres/*.csv' \
        --path_annots '.../center_levels/*.csv' --path_out ./results
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.apps.run_center_candidate_training import (
    load_center_annotation)
from pyimsegm_tpu_torch.centers import evaluate_detected_centers

NAME_CSV = 'statistic_center_detection.csv'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_centers', '', 'detected centre CSVs',
                        required=True)
    common.add_path_arg(parser, 'path_annots', '', 'annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--dist_thr', type=float, default=50.0)
    common.add_device_arg(parser)
    return common.parse_arg_params(parser, {})


def main(params):
    import pandas as pd
    from pyimsegm_tpu_torch.utils.data_io import \
        find_files_match_names_across_dirs
    df_paths = find_files_match_names_across_dirs(
        [params['path_centers'], params['path_annots']])
    os.makedirs(params['path_out'], exist_ok=True)
    rows = {}
    for _, row in df_paths.iterrows():
        name = os.path.splitext(os.path.basename(row['path_1']))[0]
        df = pd.read_csv(row['path_1'], index_col=0)
        detected = df[['Y', 'X']].values if len(df) else np.zeros((0, 2))
        annotated = load_center_annotation(row['path_2'])
        rows[name] = evaluate_detected_centers(
            detected, annotated, dist_thr=params['dist_thr'],
            device=params.get('device', 'cuda'))
    df = pd.DataFrame.from_dict(rows, orient='index')
    df.to_csv(os.path.join(params['path_out'], NAME_CSV))
    logging.info('detection stats:\n%s', df.mean())
    return df


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
