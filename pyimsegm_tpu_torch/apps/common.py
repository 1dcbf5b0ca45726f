"""Shared CLI plumbing for the experiment apps (port of the JAX
package's ``apps/common.py``): argparse with path validation, optional YAML
config merge, experiment folder creation, image loading by declared type,
and the ``--device`` flag every app takes.
"""

import argparse
import glob
import logging
import os

import numpy as np

from pyimsegm_tpu_torch.utils import data_io
from pyimsegm_tpu_torch.utils.experiments import (
    create_experiment_folder,
    load_config_yaml,
    save_config_yaml,
    set_experiment_logger,
    string_dict,
)

#: image loading modes (`run_segm_slic_model_graphcut.py:62`)
TYPES_LOAD_IMAGE = ['2d_rgb', '2d_split', '2d_gray']


def add_path_arg(parser, name, default, help_text, required=False):
    parser.add_argument('--%s' % name, type=str, required=required,
                        default=default, help=help_text)


def add_device_arg(parser, default='cuda'):
    """``--device``: where the app's device work runs (``cuda`` by default,
    ``cpu`` for the plain PyTorch path)."""
    parser.add_argument('--device', type=str, default=default,
                        help='torch device of the device work')


def parse_arg_params(parser, params):
    """Parse args, validate path_* entries, merge optional YAML config.

    Precedence: app defaults < YAML config < explicitly-passed CLI flags.
    The reference applies ``params.update(config)`` then
    ``params.update(args)`` (`run_segm_slic_model_graphcut.py:197-200`) but
    only registers CLI flags for keys absent from its configs; our apps
    expose more flags, so an un-passed flag's argparse default must not
    clobber the YAML value while an explicit flag still wins."""
    args = vars(parser.parse_args())
    logging.info('ARG PARAMETERS: \n %r', args)
    for k in (k for k in args if 'path' in k and isinstance(args[k], str)):
        if args[k] in ('', 'none', None):
            continue
        args[k] = data_io.update_path(args[k])
        p = os.path.dirname(args[k]) if '*' in os.path.basename(args[k]) \
            else args[k]
        if k.startswith('path_out'):
            continue
        if not os.path.exists(p):
            raise FileNotFoundError('missing: (%s) "%s"' % (k, p))
    # a flag only outranks the YAML config when the user actually typed it —
    # detected from sys.argv, NOT by comparing values to argparse defaults
    # (an explicit flag equal to its default would otherwise lose to YAML,
    # and path flags with non-None defaults would always clobber YAML)
    typed = _typed_cli_dests(parser)
    explicit = {k: v for k, v in args.items() if k in typed and v is not None}
    params.update({k: v for k, v in args.items() if v is not None})
    if os.path.isfile(args.get('path_config') or ''):
        params.update(load_config_yaml(args['path_config']))
    params.update(explicit)
    return params


def _typed_cli_dests(parser, argv=None):
    """Dests of the options actually present on the command line.

    Handles ``--flag value``, ``--flag=value`` and unambiguous argparse
    prefix abbreviations of long options.
    """
    import sys
    argv = sys.argv[1:] if argv is None else argv
    tokens = {t.split('=', 1)[0] for t in argv if t.startswith('-')}
    dests = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if opt in tokens or any(
                    opt.startswith(t) and len(t) > 2 for t in tokens):
                dests.add(action.dest)
                break
    return dests


def setup_experiment(params, name_experiment, stamp_unique=False):
    """Create the experiment folder, dump config, attach the file logger."""
    os.makedirs(params['path_out'], exist_ok=True)
    path_exp = create_experiment_folder(
        params['path_out'], name_experiment + '_' + params.get('name', 'run'),
        stamp_unique=stamp_unique)
    params['path_exp'] = path_exp
    save_config_yaml(os.path.join(path_exp, 'config.yml'),
                     {k: v for k, v in params.items()
                      if isinstance(v, (str, int, float, bool, list, dict))})
    set_experiment_logger(path_exp)
    logging.info(string_dict(params, 'EXPERIMENT PARAMETERS:'))
    return path_exp


def load_image_by_type(path_img, img_type='2d_rgb'):
    """Load an image in the declared mode
    (`run_segm_slic_model_graphcut.py:204-234`).

    :returns: (image float in [0,1], name)
    """
    name = os.path.splitext(os.path.basename(path_img))[0]
    if img_type == '2d_split':
        img, _ = data_io.load_img_double_band_split(path_img)
        image = np.stack([img] * 3, axis=-1) if np.asarray(img).ndim == 2 \
            else img
    else:
        img, _ = data_io.load_image_2d(path_img)
        raw = np.asarray(img)
        if raw.ndim == 3 and raw.shape[0] in (3, 4) \
                and raw.shape[-1] not in (3, 4):
            raw = np.moveaxis(raw[:3], 0, -1)      # channels-first TIFF stack
        img = raw.astype(float)
        if np.issubdtype(raw.dtype, np.integer) and img.max() > 1.5:
            img = img / float(np.iinfo(raw.dtype).max)
        if img_type == '2d_gray' and img.ndim == 3:
            img = img.mean(axis=-1)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        image = img
    return np.asarray(image, np.float32), name


def load_annot_2d(path_annot):
    """Load an annotation as a dense int label map
    (`run_segm_slic_model_graphcut.py:225-230` '2d_segm' semantics): RGB
    annotations take channel 0, labels are relabelled to a gapless sequence
    with ``relabel_sequential`` rules — 0 stays background, nonzero labels
    map to 1..n in sorted order (so a {1, 2} annotation keeps a distinct
    background id instead of class 1 collapsing onto 0).

    :returns: (labels (H, W) int ndarray, name)
    """
    annot, name = data_io.load_image_2d(path_annot)
    annot = np.asarray(annot)
    if annot.ndim == 3:
        annot = annot[:, :, 0]
    annot = annot.astype(np.int64)
    uniq = np.unique(annot)
    nonzero = uniq[uniq != 0]
    lut = np.zeros(int(annot.max()) + 1, np.int32)
    lut[nonzero] = np.arange(1, len(nonzero) + 1, dtype=np.int32)
    return lut[annot], name


def list_images(path_pattern):
    paths = sorted(glob.glob(path_pattern))
    if not paths:
        raise FileNotFoundError('no images found for "%s"' % path_pattern)
    return paths


def find_images_annots(path_imgs, path_annots):
    """Match image and annotation files by basename; returns path pairs."""
    df = data_io.find_files_match_names_across_dirs([path_imgs, path_annots])
    return list(df['path_1']), list(df['path_2'])


def export_segm(path_dir, name, segm, segm_soft=None):
    os.makedirs(path_dir, exist_ok=True)
    data_io.export_image(os.path.join(path_dir, name), np.asarray(segm),
                         stretch_range=False)
    if segm_soft is not None:
        np.savez_compressed(os.path.join(path_dir, name + '.npz'),
                            segm_soft=np.asarray(segm_soft))
