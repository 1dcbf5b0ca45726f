"""Estimate RG2Sp ray-shape models (single + mixture) from egg annotations.

Port of the JAX package's ``apps/run_RG2Sp_estim_shape_models.py``, after the
reference's ``run_RG2Sp_estim_shape-models.py``:
collects per-egg ray signatures over all annotated images, fits the single
CDF-table model and the mixture set model, and exports them as pkl/npz.

Example::

    python -m pyimsegm_tpu_torch.apps.run_RG2Sp_estim_shape_models \
        --path_annot 'data-images/drosophila_ovary_slice/annot_eggs/*.png' \
        --path_out ./results
"""

import argparse
import glob
import logging
import os
import pickle

import numpy as np

from pyimsegm_tpu_torch import region_growing as rg
from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io

NAME_SINGLE = 'RG2SP_eggs_single-model.pkl'
NAME_MIXTURE = 'RG2SP_eggs_mixture-model.pkl'
NAME_NPZ = 'RG2SP_eggs_rays.npz'


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_annot', '', 'egg annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './results', 'output directory')
    parser.add_argument('--ray_step', type=int, default=10)
    parser.add_argument('--nb_components', type=int, default=2)
    common.add_device_arg(parser)
    return common.parse_arg_params(parser, {})


def save_shape_model(path_model, shape_type, model, tables):
    """Pickle a fitted shape model: its name, its tables (``cdfs``) and
    its arrays (``model``, :func:`region_growing.shape_model_to_numpy`),
    numpy only."""
    with open(path_model, 'wb') as fp:
        pickle.dump({'name': shape_type, 'cdfs': tables,
                     'model': rg.shape_model_to_numpy(model, tables)}, fp)


def main(params):
    device = params.get('device', 'cuda')
    paths = sorted(glob.glob(params['path_annot']))
    logging.info('found %i annotations', len(paths))
    annots = [np.asarray(data_io.load_image_2d(p)[0]).astype(int)
              for p in paths]
    list_rays, list_shifts = rg.compute_object_shapes(
        annots, ray_step=params['ray_step'], interp_order='spline',
        smooth_coef=1, device=device)
    # drop degenerate shapes (tiny fragments with unresolved ray hits)
    rays_arr = np.asarray(list_rays, float)
    ok = np.all(np.isfinite(rays_arr), axis=1) & np.all(rays_arr > 0, axis=1)
    list_rays = rays_arr[ok].tolist()
    list_shifts = np.asarray(list_shifts)[ok].tolist()
    logging.info('collected %i egg shapes (%i dropped)', len(list_rays),
                 int(np.sum(~ok)))
    os.makedirs(params['path_out'], exist_ok=True)
    np.savez_compressed(os.path.join(params['path_out'], NAME_NPZ),
                        rays=np.asarray(list_rays),
                        shifts=np.asarray(list_shifts))

    model_single, cdf = rg.transform_rays_model_cdf_mixture(list_rays,
                                                            device=device)
    save_shape_model(os.path.join(params['path_out'], NAME_SINGLE), 'cdf',
                     model_single, cdf)

    model_mix, mean_cdf = rg.transform_rays_model_sets_mean_cdf_mixture(
        list_rays, params['nb_components'], device=device)
    save_shape_model(os.path.join(params['path_out'], NAME_MIXTURE),
                     'set_cdfs', model_mix, mean_cdf)
    logging.info('exported single + mixture shape models')
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
