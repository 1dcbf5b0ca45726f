"""Annotation handling: colour <-> label conversion, quantisation to a
palette, inpainting and landmark grouping (port of
``pyimsegm_tpu.annotation``).

The nearest-colour quantisation runs on the image's device: a running
minimum of the L1 distance over the palette, one pass over the pixels per
palette entry, so no (pixels x colours) array is ever held.  The rest is
host numpy / scipy, as in the JAX package.
"""

import os

import numpy as np
import torch

from pyimsegm_tpu_torch.utils import ImageDimensionError
from pyimsegm_tpu_torch.utils.device import as_tensor, host_array

#: annotated landmark columns
COLUMNS_POSITION = ('ant_x', 'ant_y', 'post_x', 'post_y', 'lat_x', 'lat_y')
SLICE_NAME_GROUPING = 'stack_path'
#: z-distance tolerance per egg stage
ANNOT_SLICE_DIST_TOL = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 0}
#: default label colours
DICT_COLOURS = {
    0: (0, 0, 255),
    1: (255, 0, 0),
    2: (0, 255, 0),
    3: (255, 229, 0),
    4: (142, 68, 173),
    5: (127, 140, 141),
    6: (0, 212, 255),
    7: (128, 0, 0),
}


def unique_image_colors(img):
    """All unique colours of an RGB image, as a sorted list of (r, g, b)."""
    arr = host_array(img)
    uq = np.unique(arr.reshape(-1, arr.shape[-1])[:, :3], axis=0)
    return [tuple(int(v) for v in c) for c in uq]


def convert_img_colors_to_labels(img_rgb, lut_label_color):
    """RGB annotation -> label map by a {label: colour} dictionary.

    >>> seg = np.array([[0, 1, 1], [1, 0, 0]])
    >>> img = np.array([(0.2, 0.2, 0.2), (0.9, 0.9, 0.9)])[seg]
    >>> convert_img_colors_to_labels(img, {0: (0.2, 0.2, 0.2),
    ...                                    1: (0.9, 0.9, 0.9)})
    array([[0, 1, 1],
           [1, 0, 0]])
    """
    return convert_img_colors_to_labels_reverted(
        img_rgb, {tuple(v): k for k, v in lut_label_color.items()})


def convert_img_colors_to_labels_reverted(img_rgb, dict_color_label):
    """RGB annotation -> label map by a {colour: label} dictionary; raises
    when a pixel matches no colour."""
    img_rgb = host_array(img_rgb)
    img_labels = np.zeros(img_rgb.shape[:-1], dtype=int)
    matched = np.zeros(img_rgb.shape[:-1], dtype=bool)
    for color, label in dict_color_label.items():
        m = np.all(img_rgb == np.asarray(color), axis=2)
        img_labels[m] = label
        matched |= m
    if not np.all(matched):
        raise ValueError('There is different number of pixels than number of'
                         ' converted labels.')
    return img_labels


def convert_img_labels_to_colors(segm, lut_label_colors):
    """Label map -> RGB image; labels between the smallest and the largest
    that the dictionary lacks are black."""
    segm = host_array(segm)
    uq = np.unique(segm)
    if not all(lb in lut_label_colors for lb in uq):
        raise ValueError('some labels %r are missing in dictionary %r'
                         % (uq, list(lut_label_colors.keys())))
    min_label = int(segm.min())
    lut = [lut_label_colors.get(i + min_label)
           for i in range(int(segm.max()) - min_label + 1)]
    lut = [c if c is not None else (0, 0, 0) for c in lut]
    return np.array(lut)[segm - min_label]


def image_frequent_colors(img, ratio_threshold=1e-3):
    """{(r, g, b): pixel count} of the colours covering at least
    ``ratio_threshold`` of the pixels."""
    img = host_array(img)
    if img.ndim == 3:
        img = img[:, :, :3]
    pixels = img.reshape(-1, img.shape[-1])
    colors, counts = np.unique(pixels, axis=0, return_counts=True)
    keep = counts >= len(pixels) * ratio_threshold
    return {tuple(int(v) for v in c): int(n)
            for c, n in zip(colors[keep], counts[keep])}


def group_images_frequent_colors(paths_img, ratio_threshold=1e-3):
    """Frequent colours summed over image files."""
    from pyimsegm_tpu_torch.utils.data_io import io_imread
    dict_colors = {}
    for path_im in paths_img:
        for clr, cnt in image_frequent_colors(io_imread(path_im),
                                              ratio_threshold).items():
            dict_colors[clr] = dict_colors.get(clr, 0) + cnt
    return dict_colors


def _nearest_color_lut(img, colors, device='cuda'):
    """(H, W) int64 index of each pixel's L1-nearest palette colour, on the
    image's device: a running minimum with a strict ``<``, so a tie goes to
    the first colour, as an ``argmin`` breaks it."""
    pixels = as_tensor(img, device).to(torch.float32)
    shape = pixels.shape[:2]
    pixels = pixels.reshape(-1, pixels.shape[-1])
    palette = torch.as_tensor(np.asarray(list(colors), np.float32),
                              device=pixels.device)
    best = torch.full((pixels.shape[0],), float('inf'),
                      dtype=torch.float32, device=pixels.device)
    index = torch.zeros(pixels.shape[0], dtype=torch.int64,
                        device=pixels.device)
    for p in range(palette.shape[0]):
        dist = torch.sum(torch.abs(pixels - palette[p]), dim=-1)
        closer = dist < best
        best = torch.where(closer, dist, best)
        index = torch.where(closer, p, index)
    return index.reshape(shape)


def image_color_2_labels(img, colors=None, device='cuda'):
    """(H, W) index of each pixel's nearest colour (by default, of the
    image's frequent colours), as numpy."""
    if not colors:
        colors = list(image_frequent_colors(img).keys())
    return _nearest_color_lut(img, colors, device).cpu().numpy()


def quantize_image_nearest_color(img, colors, device='cuda'):
    """The image with every pixel replaced by its nearest colour, as numpy
    of the image's dtype."""
    dtype = (torch.empty(0, dtype=img.dtype).numpy().dtype
             if isinstance(img, torch.Tensor) else np.asarray(img).dtype)
    lut = _nearest_color_lut(img, colors, device).cpu().numpy()
    return np.asarray(np.asarray(list(colors))[lut], dtype=dtype)


def image_inpaint_pixels(img, valid_mask):
    """Fill the invalid pixels with the value of the nearest valid one."""
    from scipy import interpolate
    img = host_array(img)
    valid_mask = host_array(valid_mask).astype(bool)
    if img.shape != valid_mask.shape:
        raise ImageDimensionError('image size %r and mask size %r should be'
                                  ' equal' % (img.shape, valid_mask.shape))
    coords = np.array(np.nonzero(valid_mask)).T
    it = interpolate.NearestNDInterpolator(coords, img[valid_mask])
    return it(list(np.ndindex(img.shape))).reshape(img.shape)


def quantize_image_nearest_pixel(img, colors):
    """Pixels that hit a palette colour exactly keep it; every other pixel
    takes the colour of its nearest such pixel."""
    img = host_array(img)
    palette = np.asarray(list(colors))
    hits = (img[None] == palette[:, None, None, :]).all(axis=-1)
    matched = hits.any(axis=0)
    labels = hits.argmax(axis=0).astype(float)
    labels[~matched] = np.nan
    filled = image_inpaint_pixels(labels, matched).astype(int)
    return palette[filled]


def load_info_group_by_slices(path_txt, stages,
                              pos_columns=COLUMNS_POSITION,
                              dict_slice_tol=ANNOT_SLICE_DIST_TOL):
    """Landmark annotations of ovary stacks of the given stages, each
    image's row holding the positions of the slices within its stage's
    z-tolerance.

    :returns: DataFrame indexed by image name
    """
    import pandas as pd
    df = pd.read_csv(path_txt, sep='\t', index_col=0)
    df = df[df['stage'].isin(list(stages))]
    df = df.sort_values(['stage'], ascending=False)
    rows = []
    for _, df_group in df.groupby(SLICE_NAME_GROUPING):
        slice_idxs = df_group['slice_index'].values
        slice_tols = np.array([dict_slice_tol[i]
                               for i in df_group['stage'].values])
        for _, row in df_group.iterrows():
            near = np.abs(slice_idxs - row['slice_index']) <= slice_tols
            dict_slice = {col: df_group[col].values[near]
                          for col in pos_columns}
            dict_slice['image'] = os.path.splitext(row['image_path'])[0]
            rows.append(dict_slice)
    df_marked = pd.DataFrame(rows)
    if not df_marked.empty:
        df_marked.set_index('image', inplace=True)
    return df_marked
