"""Interactive matplotlib tool to correct egg-centre annotations.

Port of the JAX package's ``apps/gui_annot_center_correction.py``, after the
reference's ``gui_annot_center_correction.py``:
shows each image with its current centre points; left-click adds a centre,
right-click removes the nearest one, keys save ('s' or closing the window
moves to the next image).  Requires an interactive matplotlib backend; in
headless runs use ``--dry`` to only re-export the unchanged CSVs.

Example::

    python -m pyimsegm_tpu_torch.apps.gui_annot_center_correction \
        --path_images '.../image/*.jpg' --path_centers '.../centres/*.csv' \
        --path_out ./corrected
"""

import argparse
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils import data_io


def arg_parse_params():
    parser = argparse.ArgumentParser()
    common.add_path_arg(parser, 'path_images', '', 'image pattern',
                        required=True)
    common.add_path_arg(parser, 'path_centers', '', 'centre CSV pattern',
                        required=True)
    common.add_path_arg(parser, 'path_out', './corrected', 'output folder')
    parser.add_argument('--dry', action='store_true', default=False,
                        help='no GUI: copy CSVs through unchanged')
    return common.parse_arg_params(parser, {})


class CenterEditor:
    """Click-to-edit centre list over one image."""

    def __init__(self, ax, points):
        self.ax = ax
        self.points = [list(map(float, p)) for p in points]
        self._plot = ax.plot([p[1] for p in self.points],
                             [p[0] for p in self.points], 'o', color='y')[0]
        ax.figure.canvas.mpl_connect('button_press_event', self.on_click)

    def on_click(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        pos = [event.ydata, event.xdata]
        if event.button == 1:                       # add
            self.points.append(pos)
        elif event.button == 3 and self.points:     # remove nearest
            d = [np.hypot(p[0] - pos[0], p[1] - pos[1]) for p in self.points]
            self.points.pop(int(np.argmin(d)))
        self._plot.set_data([p[1] for p in self.points],
                            [p[0] for p in self.points])
        self.ax.figure.canvas.draw_idle()


def main(params):
    import pandas as pd
    os.makedirs(params['path_out'], exist_ok=True)
    df_paths = data_io.find_files_match_names_across_dirs(
        [params['path_images'], params['path_centers']])
    for _, row in df_paths.iterrows():
        img, name = data_io.load_image_2d(row['path_1'])
        df = pd.read_csv(row['path_2'], index_col=0)
        points = df[['Y', 'X']].values.tolist() if len(df) else []
        if not params.get('dry'):
            import matplotlib
            import matplotlib.pyplot as plt
            if matplotlib.get_backend().lower() == 'agg':
                logging.warning('headless backend; falling back to --dry')
                params['dry'] = True
            else:
                fig, ax = plt.subplots(figsize=(10, 8))
                ax.imshow(img)
                ax.set_title('%s - left-click add / right-click remove;'
                             ' close to save' % name)
                editor = CenterEditor(ax, points)
                plt.show()
                points = editor.points
        pd.DataFrame([(p[0], p[1]) for p in points],
                     columns=['Y', 'X']).to_csv(
            os.path.join(params['path_out'], name + '.csv'))
        logging.info('saved %i centres for "%s"', len(points), name)
    return params


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main(arg_parse_params())
