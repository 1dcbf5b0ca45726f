"""Match estimated ellipses to user landmark annotations by Jaccard overlap.

Port of the JAX package's ``apps/run_ellipse_annot_match.py``, after the
reference's ``run_ellipse_annot_match.py``: for
each annotated egg (3-point landmarks in the info table), rasterise the
annotation rectangle, compare it with every estimated ellipse of that image
and keep the best match above the threshold.

Example::

    python -m pyimsegm_tpu_torch.apps.run_ellipse_annot_match \
        --path_info '.../info_ovary_images.txt' \
        --path_ellipses 'results/ellipses/*.csv' --path_out ./results
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import ellipse_fitting as ell_fit
from pyimsegm_tpu_torch.utils import drawing

OVERLAP_THRESHOLD = 0.45
COLUMNS_ELLIPSE = ('xc', 'yc', 'a', 'b', 'theta')


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_info', '', 'landmark info table',
                        required=True)
    common.add_path_arg(parser, 'path_ellipses', '',
                        'per-image ellipse CSV pattern', required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output folder')
    parser.add_argument('--overlap_thr', type=float,
                        default=OVERLAP_THRESHOLD)
    return common.parse_arg_params(parser, {})


def select_optimal_ellipse(row, path_dir_csv, overlap_thr=OVERLAP_THRESHOLD):
    """Best-Jaccard ellipse for one annotated egg
    (`run_ellipse_annot_match.py:95-143`)."""
    import pandas as pd
    dict_row = dict(row)
    name = os.path.splitext(str(row['image_path']))[0]
    path_csv = os.path.join(path_dir_csv, os.path.basename(name) + '.csv')
    if not os.path.isfile(path_csv):
        return dict_row
    df_ellipses = pd.read_csv(path_csv, index_col=0)

    pos = [row[c] for c in drawing.COLUMNS_POSITION_EGG_ANNOT]
    max_size = int(2 * max(pos) + min(pos))
    mask_ref = drawing.draw_eggs_rectangle(
        (max_size, max_size), [[row['ant_x'], row['ant_y']]],
        [[row['lat_x'], row['lat_y']]], [[row['post_x'], row['post_y']]])[0]

    jaccards = []
    for _, ell_row in df_ellipses.iterrows():
        mask_ell = ell_fit.add_overlap_ellipse(
            np.zeros(mask_ref.shape, int), ell_row.values.tolist(), 1)
        inter = np.sum((mask_ref > 0) & (mask_ell > 0))
        union = np.sum((mask_ref > 0) | (mask_ell > 0))
        jaccards.append(inter / max(float(union), 1.0))
    if not jaccards or max(jaccards) < overlap_thr:
        dict_row['ellipse_Jaccard'] = max(jaccards) if jaccards else 0.0
        return dict_row

    best = dict(df_ellipses.iloc[int(np.argmax(jaccards))])
    if best.get('b', 0) > best.get('a', 0):
        best['a'], best['b'] = best['b'], best['a']
        best['theta'] = best.get('theta', 0) + np.deg2rad(90)
    best['Jaccard'] = max(jaccards)
    dict_row.update({'ellipse_' + n: best[n] for n in best})
    return dict_row


def main(params):
    import pandas as pd
    df_info = pd.read_csv(params['path_info'], sep='\t', index_col=0)
    path_dir = os.path.dirname(params['path_ellipses'])
    names_avail = {os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(params['path_ellipses'])}
    df_info = df_info[[os.path.splitext(os.path.basename(str(p)))[0]
                       in names_avail for p in df_info['image_path']]]
    logging.info('matching %i annotated eggs', len(df_info))
    rows = [select_optimal_ellipse(row, path_dir, params['overlap_thr'])
            for _, row in df_info.iterrows()]
    df_out = pd.DataFrame(rows)
    os.makedirs(params['path_out'], exist_ok=True)
    df_out.to_csv(os.path.join(params['path_out'],
                               'info_ovary_images_ellipses.csv'))
    return df_out


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
