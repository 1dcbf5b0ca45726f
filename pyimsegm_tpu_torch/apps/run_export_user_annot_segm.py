"""Export user-annotation figures: image + egg annotation + segmentation.

Port of the JAX package's ``apps/run_export_user_annot_segm.py``, after the
reference's ``run_export_user-annot-segm.py``:
per image, render the user landmark annotation (ellipse masks) over the image
with the automatic segmentation contour and export the sheet.

Example::

    python -m pyimsegm_tpu_torch.apps.run_export_user_annot_segm \
        --path_images '.../image/*.jpg' --path_annots '.../annot_eggs/*.png' \
        --path_segms '.../segm/*.png' --path_out ./annot_sheets
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io, drawing


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_annots', '', 'egg annotation pattern',
                        required=True)
    common.add_path_arg(parser, 'path_segms', '', 'segmentation pattern')
    common.add_path_arg(parser, 'path_out', './annot_sheets', 'output folder')
    return common.parse_arg_params(parser, {})


def export_figure(name, img, annot, segm, path_out):
    import matplotlib.pyplot as plt
    ncols = 2 if segm is None else 3
    fig, axarr = plt.subplots(ncols=ncols,
                              figsize=(6 * ncols,
                                       6 * img.shape[0] / img.shape[1]))
    axarr[0].set_title('image')
    axarr[0].imshow(img)
    axarr[1].set_title('egg annotation')
    axarr[1].imshow(img)
    axarr[1].contour(annot, colors='y')
    axarr[1].imshow(np.ma.masked_where(annot == 0, annot), alpha=0.3,
                    cmap=plt.cm.jet)
    if segm is not None:
        axarr[2].set_title('segmentation')
        axarr[2].imshow(segm, cmap=plt.cm.jet)
    for ax in axarr:
        ax.axis('off')
    fig.tight_layout()
    fig.savefig(os.path.join(path_out, name + '.png'))
    plt.close(fig)


def main(params):
    patterns = [params['path_images'], params['path_annots']]
    if params.get('path_segms'):
        patterns.append(params['path_segms'])
    df = data_io.find_files_match_names_across_dirs(patterns)
    os.makedirs(params['path_out'], exist_ok=True)
    for _, row in df.iterrows():
        img, name = data_io.load_image_2d(row['path_1'])
        annot, _ = data_io.load_image_2d(row['path_2'])
        segm = None
        if 'path_3' in row and isinstance(row['path_3'], str):
            segm, _ = data_io.load_image_2d(row['path_3'])
        export_figure(name, np.asarray(img), np.asarray(annot).astype(int),
                      segm, params['path_out'])
        logging.info('exported sheet "%s"', name)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
