"""Egg-center candidate training: features at SLIC centres -> classifier.

Port of the JAX package's ``apps/run_center_candidate_training.py``, after the
reference's ``run_center_candidate_training.py``:
for each (image, segmentation, centers) triple, candidate points are SLIC
centres, features are annuli label histograms + ray features, labels come
from distance to annotated centres; a classifier is searched/trained and
exported, with optional leave-one-image-out evaluation.

Example::

    python -m pyimsegm_tpu_torch.apps.run_center_candidate_training \
        --path_list 'data-images/drosophila_ovary_slice/list_imgs-segm-center-points_short.csv' \
        --path_out ./results
"""

import argparse
import logging
import os
import pickle
import time

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import centers as ctr
from pyimsegm_tpu_torch.utils import data_io
from pyimsegm_tpu_torch.utils.experiments import append_final_stat

NAME_EXPERIMENT = 'detect-centers-train'
#: relabeling of loaded center-level annotations
#: (`run_center_candidate_training.py:79`): level 2 is "uncertain" -> -1
LUT_ANNOT_CENTER_RELABEL = [0, 0, -1, 1]


def arg_parse_params(params):
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_list', params.get('path_list', ''),
                        'CSV list with image/segm/center paths')
    common.add_path_arg(parser, 'path_out', params.get('path_out',
                                                       './results'),
                        'output directory')
    common.add_path_arg(parser, 'path_config', '', 'YAML config')
    parser.add_argument('--name', type=str, default=params.get('name',
                                                               'ovary'))
    parser.add_argument('--nb_classif_search', type=int,
                        default=params.get('nb_classif_search', 5))
    parser.add_argument('--unique', action='store_true', default=False)
    common.add_device_arg(parser, params.get('device', 'cuda'))
    return common.parse_arg_params(parser, params)


def load_triples(path_list):
    """Load the (image, segm, centers CSV) path triples from the list CSV
    and resolve them against the list's base directory."""
    import pandas as pd
    df = pd.read_csv(path_list, index_col=0)
    # relative entries like 'data-images/...' resolve against the tree root
    # two levels above the list file (reference layout)
    base = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(path_list))))
    cols = ['path_image', 'path_segm', 'path_centers']
    triples = []
    for _, row in df.iterrows():
        paths = [str(row[c]) if str(row[c]).startswith('/')
                 else os.path.join(base, str(row[c])) for c in cols]
        triples.append(paths)
    return triples


def load_center_annotation(path_centers):
    """Centers from a CSV of positions or a center-level annotation image."""
    if path_centers.endswith('.csv'):
        import pandas as pd
        df = pd.read_csv(path_centers, index_col=0)
        # CSV uses (X, Y) image coords -> (row, col)
        return [(float(r['Y']), float(r['X'])) for _, r in df.iterrows()]
    annot, _ = data_io.load_image_2d(path_centers)
    annot = np.asarray(annot).astype(int)
    lut = np.asarray(LUT_ANNOT_CENTER_RELABEL)
    mask = lut[np.clip(annot, 0, len(lut) - 1)] == 1
    from scipy import ndimage
    lab, n = ndimage.label(mask)
    return [tuple(map(float, c))
            for c in ndimage.center_of_mass(mask, lab, range(1, n + 1))]


def main(params):
    t_start = time.time()
    path_out = common.setup_experiment(params, NAME_EXPERIMENT,
                                       stamp_unique=params.get('unique',
                                                               False))
    triples = load_triples(params['path_list'])
    logging.info('found %i triples', len(triples))

    imgs, segms, centers_list = [], [], []
    for p_img, p_segm, p_ctr in triples:
        img, _name = common.load_image_by_type(p_img, '2d_rgb')
        segm, _ = data_io.load_image_2d(p_segm)
        imgs.append(img)
        segms.append(np.asarray(segm).astype(int))
        centers_list.append(load_center_annotation(p_ctr))

    cp = {k: params[k] for k in params if k in ctr.CENTER_PARAMS}
    device = params.get('device', 'cuda')
    classif, dict_imgs = ctr.train_center_classifier(
        segms, imgs, centers_list, cp, path_out=path_out, device=device)

    # export per-image candidate data for downstream stages
    np.savez_compressed(
        os.path.join(path_out, 'dump_training_data.npz'),
        **{('%s_labels' % k): v['labels'] for k, v in dict_imgs.items()})
    with open(os.path.join(path_out, 'center_params.pkl'), 'wb') as fp:
        pickle.dump({k: v for k, v in params.items()
                     if isinstance(v, (str, int, float, list, dict, bool))},
                    fp)

    # leave-one-out detection evaluation
    stats = {}
    if len(imgs) > 1:
        f1s = []
        for i in range(len(imgs)):
            train_idx = [j for j in range(len(imgs)) if j != i]
            clf_i, _ = ctr.train_center_classifier(
                [segms[j] for j in train_idx], [imgs[j] for j in train_idx],
                [centers_list[j] for j in train_idx], cp, device=device)
            out = ctr.load_compute_detect_centers(imgs[i], segms[i], clf_i,
                                                  cp, device=device)
            s = ctr.evaluate_detected_centers(
                out['centers'], centers_list[i],
                dist_thr=cp.get('center_dist_thr', 50), device=device)
            f1s.append(s['f1'])
        stats['LOO_mean_f1'] = float(np.mean(f1s))
        logging.info('leave-one-out f1: %r', f1s)
    append_final_stat(path_out, params, stats, t_start)
    return classif, params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params(dict(ctr.CENTER_PARAMS)))
