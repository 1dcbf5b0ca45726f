"""Interactive unsupervised segmentation demo.

Port of the JAX package's ``apps/demo_interactive_segmentation.py``, after
the reference's ``streamlit-app.py:41-47``: fits a group model
with ``estim_model_classes_group`` and segments the chosen image with
``segment_color2d_slic_features_model_graphcut``, showing/saving the result
sheet.  Run headless with --path_out or interactively with --show.

Example::

    python -m pyimsegm_tpu_torch.apps.demo_interactive_segmentation \
        --path_image 'data-images/drosophila_disc/image/img_5.jpg' \
        --nb_classes 3 --path_out ./demo_out
"""

import argparse
import logging
import os

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch import pipelines
from pyimsegm_tpu_torch.utils import drawing


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_image', '', 'input image',
                        required=True)
    common.add_path_arg(parser, 'path_out', './demo_out', 'output folder')
    parser.add_argument('--nb_classes', type=int, default=3)
    parser.add_argument('--sp_size', type=int, default=25)
    parser.add_argument('--sp_regul', type=float, default=0.2)
    parser.add_argument('--gc_regul', type=float, default=1.0)
    parser.add_argument('--show', action='store_true', default=False)
    common.add_device_arg(parser)
    return common.parse_arg_params(parser, {})


def main(params):
    img, name = common.load_image_by_type(params['path_image'])
    model, _ = pipelines.estim_model_classes_group(
        [img], params['nb_classes'], {'color': ['mean', 'std', 'energy']},
        sp_size=params['sp_size'], sp_regul=params['sp_regul'],
        device=params.get('device', 'cuda'))
    segm, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
        img, model, {'color': ['mean', 'std', 'energy']},
        sp_size=params['sp_size'], sp_regul=params['sp_regul'],
        gc_regul=params['gc_regul'])
    fig = drawing.figure_image_segm_results(img, segm)
    os.makedirs(params['path_out'], exist_ok=True)
    path_fig = os.path.join(params['path_out'], name + '_demo.png')
    fig.savefig(path_fig)
    logging.info('saved %s', path_fig)
    if params['show']:
        import matplotlib.pyplot as plt
        plt.show()
    return segm


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
