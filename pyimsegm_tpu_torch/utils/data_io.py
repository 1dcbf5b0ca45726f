"""Image / landmark IO, intensity scaling, folder matching and object
cropping, host numpy (port of ``pyimsegm_tpu.utils.data_io``).

Image files are read and written through PIL (multi-frame TIFF volumes
included), which is imported inside the functions that open or save a
file: the module imports without PIL, and such a function raises an
``ImportError`` that names PIL.  Also the double-band split of the
'2d_split' image type, percentile intensity scaling, the landmark txt /
csv formats, cross-directory name matching and the object cut-out with
principal-axis rotation.
"""

import glob
import logging
import os
import re
import warnings

import numpy as np

from pyimsegm_tpu_torch.ops.color import (  # noqa: F401  (public re-export)
    convert_img_color_from_rgb,
    convert_img_color_to_rgb,
)
from pyimsegm_tpu_torch.utils import ImageDimensionError

#: landmark coordinate columns
COLUMNS_COORDS = ('X', 'Y')


def update_path(path_file, lim_depth=5, absolute=True):
    """Anchor a relative path by walking up parent directories."""
    if path_file.startswith('/'):
        return path_file
    if path_file.startswith('~'):
        path_file = os.path.expanduser(path_file)
    else:
        tmp_path = path_file
        for _ in range(lim_depth):
            if os.path.exists(tmp_path):
                path_file = tmp_path
                break
            tmp_path = os.path.join('..', tmp_path)
    if absolute:
        path_file = os.path.abspath(path_file)
    return path_file


def swap_coord_x_y(points):
    """Swap (x, y) -> (y, x) per row.

    >>> swap_coord_x_y(np.array([[1, 2], [2, 4], [5, 6]]))
    [[2, 1], [4, 2], [6, 5]]
    """
    points = np.array(points)
    if not points.size:
        return points.tolist()
    if points.shape[1] != 2:
        raise ValueError
    return points[:, [1, 0]].tolist()


# -------------------------------------------------------------- landmarks ---

def load_landmarks_txt(path_file):
    """Landmarks from the 'point / count / x y' text format."""
    path_file = os.path.abspath(os.path.expanduser(path_file))
    if not os.path.isfile(path_file):
        raise FileNotFoundError('missing "%s"' % path_file)
    with open(path_file, 'r') as fp:
        lines = fp.readlines()
    landmarks = []
    for line in lines[2:]:
        match = re.match(r'(.*) (.*)', line)
        landmarks.append([int(float(v)) for v in match.groups()])
    return landmarks


def load_landmarks_csv(path_file):
    """Landmarks from a CSV with X/Y columns."""
    import pandas as pd
    path_file = os.path.abspath(os.path.expanduser(path_file))
    if not os.path.isfile(path_file):
        raise FileNotFoundError('missing "%s"' % path_file)
    df = pd.read_csv(path_file, index_col=0)
    return df[list(COLUMNS_COORDS)].values.tolist()


def save_landmarks_txt(path_file, landmarks):
    """Save landmarks in the text format."""
    if not os.path.isdir(os.path.dirname(path_file)):
        raise FileNotFoundError('missing "%s"' % os.path.dirname(path_file))
    path_file = os.path.splitext(path_file)[0] + '.txt'
    with open(path_file, 'w') as fp:
        fp.write('point\n%i\n' % len(landmarks))
        for el in landmarks:
            fp.write('%i %i\n' % (int(el[0]), int(el[1])))
    return path_file


def save_landmarks_csv(path_file, landmarks, dtype=float):
    """Save landmarks as CSV with X/Y columns."""
    import pandas as pd
    if not os.path.isdir(os.path.dirname(path_file)):
        raise FileNotFoundError('missing "%s"' % os.path.dirname(path_file))
    path_file = os.path.splitext(path_file)[0] + '.csv'
    landmarks = np.array(landmarks, dtype=dtype)
    if not landmarks.size:
        landmarks = np.zeros((0, 2), dtype=dtype)
    pd.DataFrame(landmarks, columns=list(COLUMNS_COORDS)).to_csv(path_file)
    return path_file


# ---------------------------------------------------------------- scaling ---

def scale_image_vals_in_range(img, im_range=1.):
    """Min-max scale to [0, range]."""
    img = (img - np.min(img)) / float(np.max(img) - np.min(img))
    if im_range == 255:
        img = (img * im_range).astype(np.uint8)
    return img


def scale_image_intensity(img, im_range=1., quantiles=(2, 98)):
    """Percentile-clipped intensity rescale."""
    p_low = np.percentile(img, quantiles[0])
    p_high = np.percentile(img, quantiles[1])
    img = np.clip((img.astype(float) - p_low) / max(p_high - p_low, 1e-12),
                  0.0, 1.0)
    if im_range == 255:
        img = np.array(img * im_range).astype(np.uint8)
    return img


# ------------------------------------------------------------------- read ---

def _pil_image():
    """PIL's ``Image`` module; an ``ImportError`` naming PIL without it."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError('reading or writing an image file needs PIL '
                          '(Pillow), which is not installed') from err
    return Image


def io_imread(path_img):
    """Robust image read; multi-frame TIFFs return (Z, H, W[, C]) volumes."""
    Image = _pil_image()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        im = Image.open(path_img)
        frames = getattr(im, 'n_frames', 1)
        if frames > 1:
            vol = []
            for i in range(frames):
                im.seek(i)
                vol.append(np.asarray(im))
            return np.asarray(vol)
        return np.asarray(im)


def image_open(path_img):
    """PIL open wrapper."""
    Image = _pil_image()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return Image.open(path_img)


def io_imsave(path_img, img):
    """Robust image save via PIL."""
    img = np.asarray(img)
    Image = _pil_image()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        if img.ndim == 3 and img.shape[0] not in (1, 3, 4) \
                and img.shape[-1] not in (1, 3, 4):
            # volume -> multi-frame TIFF
            frames = [Image.fromarray(sl) for sl in img]
            frames[0].save(path_img, save_all=True, append_images=frames[1:])
        else:
            Image.fromarray(img).save(path_img)


def load_image_2d(path_img):
    """Load any supported image; returns (image, name)."""
    if not os.path.exists(path_img):
        raise FileNotFoundError('missing: %s' % path_img)
    n_img, img_ext = os.path.splitext(os.path.basename(path_img))
    if img_ext in ('.tif', '.tiff'):
        img = io_imread(path_img)
    else:
        im = image_open(path_img)
        if im.mode == '1':
            im = im.convert('L')
        img = np.asarray(im)
        if img.ndim == 3 and img.shape[-1] > 3:
            img = img[:, :, :3]
    return img, n_img


def export_image(path_img, img, stretch_range=True):
    """Export 2D images as PNG and volumes as TIFF."""
    img = np.asarray(img)
    if img.ndim < 2:
        raise ImageDimensionError('wrong image dim: %r' % img.shape)
    if not os.path.isdir(os.path.dirname(path_img)):
        return ''
    if img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3):
        if stretch_range and img.max() > 0:
            img = img / float(img.max()) * 255
        path_img = os.path.splitext(path_img)[0] + '.png'
        io_imsave(path_img, img.astype(np.uint8))
    elif img.ndim == 3:
        if stretch_range and img.max() > 0:
            img = img / float(img.max()) * 255 ** 2
        path_img = os.path.splitext(path_img)[0] + '.tiff'
        io_imsave(path_img, img.astype(np.int32))
    else:
        logging.warning('not supported image format: %r', img.shape)
    return path_img


def load_params_from_txt(path_file):
    """'key : value' parameter files."""
    params = {}
    with open(path_file, 'r') as fp:
        for line in fp:
            if ':' not in line:
                continue
            key, val = line.split(':', 1)
            params[key.strip()] = val.strip()
    return params


# ---------------------------------------------------------------- volumes ---

def load_image_tiff_volume(path_img, im_range=None):
    """TIFF volume or RGB tiff."""
    path_img = update_path(path_img)
    if not os.path.isfile(path_img):
        raise FileNotFoundError('given image "%s" not exist!' % path_img)
    img = io_imread(path_img)
    if img.ndim == 4 and img.shape[1] == 3:
        img = np.rollaxis(img, 1, 4)
    if im_range is not None:
        img = scale_image_intensity(img, im_range)
    return img


def load_tiff_volume_split_double_band(path_img, im_range=None):
    """Split an interleaved two-band TIFF stack c1,c2,c1,c2,...."""
    img = load_image_tiff_volume(path_img, im_range)
    if img.ndim == 3 and img.shape[2] == 3:
        img_b1 = img[np.newaxis, ..., 0]
        img_b2 = img[np.newaxis, ..., 1]
    elif img.shape[0] == 3:
        img_b1 = img[np.newaxis, 0, ...]
        img_b2 = img[np.newaxis, 1, ...]
    else:
        img_b1 = np.array(img[0::2])
        img_b2 = np.array(img[1::2])
        if not img_b2.size:
            if img_b1.ndim != 4:
                raise ImageDimensionError('image is not stack of RGB')
            img_b2 = np.array([img_b1[0, :, :, 1]])
            img_b1 = np.array([img_b1[0, :, :, 0]])
    if img_b1.shape[0] != img_b2.shape[0]:
        raise ValueError('not equal slice number for %r and %r'
                         % (img_b1.shape, img_b2.shape))
    return img_b1, img_b2


def load_zvi_volume_double_band_split(path_img):
    """Split a Zeiss ZVI stack into two bands."""
    from pyimsegm_tpu_torch.utils.read_zvi import load_image as load_zvi
    if not os.path.isfile(path_img):
        raise FileNotFoundError('missing: %s' % path_img)
    img = load_zvi(path_img)
    nb_half = img.shape[0] // 2
    return img[:nb_half], img[nb_half:]


def load_img_double_band_split(path_img, im_range=1., quantiles=(2, 98)):
    """Load an image and split its two stain bands — the '2d_split' image
    type."""
    if not os.path.isfile(path_img):
        raise FileNotFoundError('missing: %s' % path_img)
    file_ext = os.path.splitext(os.path.basename(path_img))[1]
    if file_ext == '.zvi':
        img_b1, img_b2 = load_zvi_volume_double_band_split(path_img)
    elif file_ext in ('.tif', '.tiff'):
        img_b1, img_b2 = load_tiff_volume_split_double_band(path_img)
    else:
        img = io_imread(path_img)
        img_b1 = img[..., 0]
        img_b2 = img[..., 1]
    img_b1 = img_b1[0, ...] if img_b1.ndim > 2 and img_b1.shape[0] == 1 else img_b1
    img_b2 = img_b2[0, ...] if img_b2.ndim > 2 and img_b2.shape[0] == 1 else img_b2
    if im_range is not None:
        img_b1 = scale_image_intensity(img_b1, im_range, quantiles)
        img_b2 = scale_image_intensity(img_b2, im_range, quantiles)
    return img_b1, img_b2


def scale_image_size(path_img, size, path_out=None):
    """Resize an image file in place."""
    path_out = path_out if path_out else path_img
    im = image_open(path_img)
    im = im.resize(tuple(size))
    im.save(path_out)
    return path_out


# ---------------------------------------------------------------- folders ---

def load_complete_image_folder(path_dir, img_name_pattern='*.png',
                               nb_sample=None, im_range=255, skip=None):
    """Sorted folder load with optional skips."""
    paths_img = sorted(glob.glob(os.path.join(path_dir, img_name_pattern)))
    for name in (skip or []):
        paths_img = [p for p in paths_img if name not in p]
    paths_img = paths_img[:nb_sample]
    return load_images_list(paths_img, im_range)


def load_images_list(path_imgs, im_range=255):
    """Load a list of images; returns (images, names)."""
    list_images, list_names = [], []
    for path_im in path_imgs:
        im, name = load_image(path_im, im_range), None
        if im is None:
            continue
        name = os.path.splitext(os.path.basename(path_im))[0]
        list_images.append(im)
        list_names.append(name)
    return list_images, list_names


def load_image(path_im, im_range=255):
    """Load one image with optional range scaling."""
    if not path_im or not os.path.exists(path_im):
        return None
    img = io_imread(path_im)
    if im_range == 1.0:
        img = img / float(np.iinfo(img.dtype).max
                          if np.issubdtype(img.dtype, np.integer)
                          else max(img.max(), 1e-12))
    return img


def merge_image_channels(img_ch1, img_ch2, img_ch3=None):
    """Stack 2-3 single-channel images into RGB."""
    if img_ch1.ndim != 2:
        raise ImageDimensionError('image as to strictly 2D and single channel,'
                                  ' got %r' % (img_ch1.shape,))
    if img_ch1.shape != img_ch2.shape:
        raise ImageDimensionError('channel dimension has to match: %r vs %r'
                                  % (img_ch1.shape, img_ch2.shape))
    if img_ch3 is None:
        img_ch3 = np.zeros(img_ch1.shape)
    elif img_ch1.shape != img_ch3.shape:
        raise ImageDimensionError('channel dimension has to match: %r vs %r'
                                  % (img_ch1.shape, img_ch3.shape))
    return np.rollaxis(np.array([img_ch1, img_ch2, img_ch3]), 0, 3)


def _wildcard_stem(path, pattern):
    """The part of ``path``'s basename that the ``*`` wildcards of
    ``pattern`` matched: strip the pattern's literal fragments."""
    stem = os.path.splitext(os.path.basename(path))[0]
    for literal in os.path.basename(pattern).split('*'):
        if literal:
            stem = stem.replace(literal, '')
    return stem


def find_files_match_names_across_dirs(list_path_pattern, drop_none=True):
    """Join files across several glob patterns by their wildcard-matched
    name fragment.

    The first pattern anchors the row order; every later pattern fills its
    column by stem lookup into the anchor rows.

    :returns: DataFrame with columns path_1..path_N, one row per anchor
        file (rows with any unmatched column dropped unless ``drop_none``
        is False)
    """
    import pandas as pd
    patterns = [p for p in list_path_pattern if p is not None]
    if len(patterns) < 2:
        raise ValueError(
            'need two or more glob patterns to pair files, got %d'
            % len(patterns))
    absent = [os.path.dirname(p) for p in patterns
              if not os.path.exists(os.path.dirname(p))]
    if absent:
        raise FileNotFoundError('directories do not exist: %r' % absent)

    anchor = sorted(glob.glob(patterns[0]))
    rows = [[p] + [None] * (len(patterns) - 1) for p in anchor]
    row_of_stem = {}
    for idx, p in enumerate(anchor):
        row_of_stem.setdefault(_wildcard_stem(p, patterns[0]), idx)
    for col, pattern in enumerate(patterns[1:], start=1):
        for path in glob.glob(pattern):
            idx = row_of_stem.get(_wildcard_stem(path, pattern))
            if idx is not None:
                rows[idx][col] = path
    if not rows:
        rows = [[None] * len(patterns)]

    df_paths = pd.DataFrame(
        rows, columns=['path_%i' % (i + 1) for i in range(len(patterns))])
    return df_paths.dropna() if drop_none else df_paths


# ------------------------------------------------------------ object crop ---

def get_image2d_boundary_color(image, size=1):
    """Dominant/median colour along the image border.

    >>> img = np.zeros((5, 15), dtype=int)
    >>> img[:4, 3:9] = 1
    >>> int(get_image2d_boundary_color(img))
    0
    """
    size = int(size)
    image = np.asarray(image)
    if image.ndim == 2:
        bg_pixels = np.hstack([image[:size, :].ravel(), image[:, :size].ravel(),
                               image[-size:, :].ravel(), image[:, -size:].ravel()])
        bg_color = np.argmax(np.bincount(bg_pixels.astype(int)))
    elif image.ndim == 3:
        bounds = [image[:size, :], image[:, :size],
                  image[-size:, :], image[:, -size:]]
        bg_pixels = np.vstack([b.reshape(-1, image.shape[-1]) for b in bounds])
        bg_color = np.median(bg_pixels, axis=0)
    else:
        logging.error('not supported image dim: %r', image.shape)
        bg_color = np.array(0)
    return np.asarray(bg_color).astype(image.dtype)


def add_padding(img_size, padding, min_row, min_col, max_row, max_col):
    """Pad a bounding box clipped to the image.

    >>> add_padding((50, 50), 5, 15, 25, 35, 55)
    (10, 20, 40, 50)
    """
    return (max(0, min_row - padding), max(0, min_col - padding),
            min(img_size[0], max_row + padding),
            min(img_size[1], max_col + padding))


def _mask_moments(mask):
    """centroid + principal-axis angle (radians, of the major axis measured
    from the column axis) of a binary mask."""
    ys, xs = np.nonzero(mask)
    cy, cx = ys.mean(), xs.mean()
    dy, dx = ys - cy, xs - cx
    cov = np.array([[np.mean(dy * dy), np.mean(dy * dx)],
                    [np.mean(dy * dx), np.mean(dx * dx)]])
    evals, evecs = np.linalg.eigh(cov)
    major = evecs[:, np.argmax(evals)]
    angle = np.arctan2(major[0], major[1])
    return (cy, cx), angle


def cut_object(img, mask, padding, use_mask=False, bg_color=None,
               allow_rotate=True):
    """Cut the bounding box of a binary object, optionally rotating its
    principal axis horizontal first.

    >>> img = np.ones((10, 20), dtype=int)
    >>> img[3:7, 4:16] = 2
    >>> mask = np.zeros((10, 20), dtype=int)
    >>> mask[4:6, 5:15] = 1
    >>> cut_object(img, mask, 2).shape
    (6, 14)
    """
    from scipy import ndimage
    img = np.asarray(img)
    mask = np.asarray(mask).astype(float)
    if mask.shape[:2] != img.shape[:2]:
        raise ValueError('mask %r vs image %r' % (mask.shape, img.shape))

    bg_pixels = np.hstack([mask[0, :], mask[:, 0], mask[-1, :], mask[:, -1]])
    bg_mask = np.argmax(np.bincount(bg_pixels.astype(int)))
    if bg_color is None:
        bg_color = get_image2d_boundary_color(img)

    if allow_rotate:
        centroid, angle = _mask_moments(mask > 0)
        rotate = np.rad2deg(angle)
        shift = np.array(centroid) - (np.array(mask.shape) / 2.0)
        mask = ndimage.shift(mask, -shift, order=0)
        mask = ndimage.rotate(mask, rotate, order=0, mode='constant',
                              cval=np.nan)
        img = ndimage.shift(img, np.append(-shift, [0] * (img.ndim - 2)),
                            order=0)
        img = ndimage.rotate(img, rotate, order=0, mode='constant',
                             cval=np.nan,
                             axes=(1, 0) if img.ndim == 2 else (1, 0))

    img_cut = img.copy()
    img_cut[np.isnan(mask), ...] = bg_color
    mask[np.isnan(mask)] = bg_mask

    ys, xs = np.nonzero(mask > 0)
    if not len(ys):
        return img_cut
    min_row, min_col, max_row, max_col = add_padding(
        img_cut.shape, padding, ys.min(), xs.min(), ys.max() + 1, xs.max() + 1)
    img_cut = img_cut[min_row:max_row, min_col:max_col, ...]

    if use_mask:
        region = mask[min_row:max_row, min_col:max_col].astype(bool)
        img_cut[~region, ...] = bg_color
    return img_cut


# ------------------------------------------------------------------ nifti ---

def convert_img_2_nifti_gray(path_img, path_out):
    """Convert an image to grayscale NIfTI with the writer of
    :mod:`pyimsegm_tpu_torch.utils.nifti`."""
    import torch

    from pyimsegm_tpu_torch.ops.color import rgb2gray
    from pyimsegm_tpu_torch.utils.nifti import save_nifti
    if not os.path.isfile(path_img):
        raise FileNotFoundError('missing input: %s' % path_img)
    if not os.path.exists(path_out):
        raise FileNotFoundError('missing output: %s' % path_out)
    name_out = os.path.splitext(os.path.basename(path_img))[0] + '.nii'
    path_img_out = os.path.join(path_out, name_out)
    img = np.asarray(io_imread(path_img), float)
    if img.ndim == 3:
        img = rgb2gray(torch.as_tensor(img / max(img.max(), 1e-9),
                                       dtype=torch.float32)).numpy()
    img = np.swapaxes(img, 1, 0)
    return save_nifti(path_img_out, img.astype(np.float32))


def convert_img_2_nifti_rgb(path_img, path_out):
    """Convert an RGB image to NIfTI RGB24."""
    from pyimsegm_tpu_torch.utils.nifti import save_nifti
    if not os.path.isfile(path_img):
        raise FileNotFoundError('missing input: %s' % path_img)
    if not os.path.exists(path_out):
        raise FileNotFoundError('missing output: %s' % path_out)
    name_out = os.path.splitext(os.path.basename(path_img))[0] + '.nii'
    path_img_out = os.path.join(path_out, name_out)
    img = np.asarray(io_imread(path_img))
    if img.ndim != 3 or img.shape[-1] < 3:
        raise ImageDimensionError('expected RGB image, got %r' % (img.shape,))
    if img.dtype != np.uint8:
        img = (img / max(img.max(), 1e-9) * 255).astype(np.uint8)
    img = np.swapaxes(img[..., :3], 1, 0)
    return save_nifti(path_img_out, np.ascontiguousarray(img))


def convert_nifti_2_img(path_img_in, path_img_out):
    """Convert a NIfTI file back to a standard image."""
    from pyimsegm_tpu_torch.utils.nifti import load_nifti
    if not os.path.isfile(path_img_in):
        raise FileNotFoundError('missing input: %s' % path_img_in)
    img = load_nifti(path_img_in)
    img = np.swapaxes(img, 1, 0)
    if img.dtype != np.uint8:
        img = (np.clip(img / max(float(img.max()), 1e-9), 0, 1) * 255
               ).astype(np.uint8)
    io_imsave(path_img_out, img)
    return path_img_out


def io_image_decorate(func):
    """Decorator suppressing noisy PIL debug logging / decompression warnings
    around an image IO call."""
    import functools
    import logging

    @functools.wraps(func)
    def wrap(*args, **kwargs):
        log_level = logging.getLogger().getEffectiveLevel()
        logging.getLogger().setLevel(logging.INFO)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            response = func(*args, **kwargs)
        logging.getLogger().setLevel(log_level)
        return response
    return wrap
