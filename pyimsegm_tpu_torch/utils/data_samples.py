"""Sample images: the bundled microscopy samples, read from a
``data-images`` folder when it is there, and synthetic images and volumes
(numpy only; port of ``pyimsegm_tpu.utils.data_samples``)."""

import os

import numpy as np

#: root of the sample images: ``PYIMSEGM_DATA_PATH``, else the
#: ``data-images`` folder beside the package
PATH_DATA_IMAGES = os.environ.get(
    'PYIMSEGM_DATA_PATH',
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'data-images'))

IMAGE_DROSOPHILA_OVARY_2D = os.path.join(
    PATH_DATA_IMAGES, 'drosophila_ovary_slice', 'image', 'insitu7545.jpg')
ANNOT_DROSOPHILA_OVARY_2D = os.path.join(
    PATH_DATA_IMAGES, 'drosophila_ovary_slice', 'segm', 'insitu7545.png')
IMAGE_DROSOPHILA_DISC = os.path.join(
    PATH_DATA_IMAGES, 'drosophila_disc', 'image', 'img_6.jpg')
IMAGE_LANGER_ISLET = os.path.join(
    PATH_DATA_IMAGES, 'langerhans_islets', 'image', 'gtExoIsl_21.jpg')
IMAGE_HISTOL_CIMA = os.path.join(
    PATH_DATA_IMAGES, 'histology_CIMA', '29-041-Izd2-w35-CD31-3-les1.jpg')
IMAGE_STAR = os.path.join(PATH_DATA_IMAGES, 'others', 'sea_starfish-2.jpg')
IMAGE_LENNA = os.path.join(PATH_DATA_IMAGES, 'others', 'lena.png')


def has_sample_data():
    """True when the ovary sample image is there."""
    return os.path.isfile(IMAGE_DROSOPHILA_OVARY_2D)


def _read(path):
    from pyimsegm_tpu_torch.utils.data_io import io_imread
    if not os.path.isfile(path):
        raise FileNotFoundError('missing sample image: %s' % path)
    return io_imread(path)


def load_sample_image(path=IMAGE_DROSOPHILA_OVARY_2D):
    """A sample image; uint8 images as float32 in [0, 1]."""
    img = _read(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img


def load_sample_labels(path=ANNOT_DROSOPHILA_OVARY_2D):
    """An annotation as an int32 label map, its gray levels made dense
    (0..C-1)."""
    annot = _read(path)
    if annot.ndim == 3:
        annot = annot[..., 0]
    _, dense = np.unique(annot, return_inverse=True)
    return dense.reshape(annot.shape).astype(np.int32)


def get_image_path(name_img, path_base=PATH_DATA_IMAGES):
    """``name_img`` anchored to the sample folder (an absolute path stays)."""
    return name_img if os.path.isabs(name_img) \
        else os.path.join(path_base, name_img)

#: gray level of each class of :func:`sample_gray_volume_3d`: three strips
#: per z-level, two z-levels, so six piecewise-constant levels in two groups
GRAY_LEVELS_3D = (0.1, 0.3, 0.8, 0.2, 0.4, 0.9)


def sample_color_image_rand_segment(im_size=(150, 100), nb_classes=3,
                                    rand_seed=None):
    """Random blocky colour image + its segmentation: vertical class strips
    with distinct mean colours plus Gaussian noise.

    :returns: (image (H, W, 3) float32 in [0, 1], segm (H, W) int32)
    """
    rng = np.random.default_rng(rand_seed)
    h, w = im_size
    seg = np.zeros((h, w), dtype=np.int32)
    strip = w // nb_classes
    means = rng.uniform(0.1, 0.9, size=(nb_classes, 3))
    img = np.zeros((h, w, 3), dtype=np.float32)
    for c in range(nb_classes):
        x0 = c * strip
        x1 = w if c == nb_classes - 1 else (c + 1) * strip
        seg[:, x0:x1] = c
        img[:, x0:x1] = means[c]
    img += rng.normal(scale=0.05, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 1), seg


def sample_segment_vertical_2d(seg_size=(20, 10), nb_labels=3):
    """Vertical-strip segmentation: ``nb_labels`` strips of
    ``seg_size[0] // nb_labels`` columns, ``seg_size[1]`` rows.

    :returns: (seg_size[1], nb_labels * (seg_size[0] // nb_labels)) int32
    """
    cls_size = int(seg_size[0] / nb_labels)
    cls_vals = np.repeat(np.arange(nb_labels, dtype=np.int32), cls_size)
    return np.tile(cls_vals, (seg_size[1], 1))


def sample_segment_vertical_3d(seg_size=(10, 5, 6), nb_labels=3, levels=2):
    """Striped 3D segmentation: ``levels`` stacks of
    ``seg_size[2] // levels`` copies of :func:`sample_segment_vertical_2d`,
    level ``lv`` offset by ``lv * nb_labels``.

    :returns: (levels * (seg_size[2] // levels), seg_size[1], ...) int32
    """
    seg = []
    for lv in range(int(levels)):
        seg_2d = sample_segment_vertical_2d(seg_size[:2], nb_labels)
        for _ in range(int(seg_size[2] / levels)):
            seg.append(seg_2d.copy() + lv * nb_labels)
    return np.array(seg, dtype=np.int32)


def sample_gray_volume_3d(vol_size=(48, 640, 768), rand_seed=0, noise=0.05):
    """Piecewise-constant gray volume + its segmentation: the six classes
    of :func:`sample_segment_vertical_3d` (three strips along W, two levels
    along Z) at :data:`GRAY_LEVELS_3D`, plus N(0, ``noise``) noise from
    ``np.random.default_rng(rand_seed)``.

    :param vol_size: (Z, H, W) with Z even and W a multiple of 3
    :returns: (volume (Z, H, W) float32, segm (Z, H, W) int32)
    """
    z, h, w = vol_size
    seg = sample_segment_vertical_3d((w, h, z), nb_labels=3, levels=2)
    if seg.shape != tuple(vol_size):
        raise ValueError('vol_size %r needs an even Z and W a multiple of 3'
                         % (tuple(vol_size),))
    rng = np.random.default_rng(rand_seed)
    vol = np.asarray(GRAY_LEVELS_3D, np.float32)[seg]
    vol += rng.normal(0.0, noise, vol.shape).astype(np.float32)
    return vol, seg


def sample_serpentine_labels(step=16, n_tiles=(4, 5)):
    """Grid-structured labels that need more reach sweeps than the
    connectivity enforcement's cap (8): the superpixel of seed (1, 1) is a
    one-pixel-wide serpentine over the 3 x 3 tiles around it (``3 * step /
    2`` rows joined at alternate ends, so a sweep reaches one more row in
    each direction); every other pixel is labelled by its own tile's seed.

    :returns: (H, W) int32 labels, (H, W) = ``n_tiles * step``
    """
    gh, gw = n_tiles
    ty = np.arange(gh * step)[:, None] // step
    tx = np.arange(gw * step)[None, :] // step
    labels = (ty * gw + tx).astype(np.int32)
    span, target = 3 * step, gw + 1
    for k, y in enumerate(range(0, span, 2)):
        labels[y, :span] = target
        if y + 2 < span:
            labels[y + 1, span - 1 if k % 2 == 0 else 0] = target
    return labels


#: RGB colour of each tissue class of :func:`sample_ovary_scene`:
#: background, follicle ring, nurse cells, oocyte
OVARY_COLOURS = ((0.92, 0.90, 0.86), (0.55, 0.25, 0.45), (0.78, 0.58, 0.72),
                 (0.35, 0.62, 0.32))


def sample_ovary_scene(size=(647, 1024), n_eggs=4, rand_seed=0, noise=0.05):
    """Synthetic ovary slice: separate eggs (ellipses of semi-axes 0.12-0.23
    of the image's shorter side, 78-149 px at 647x1024, random orientation,
    at least 3% of that side apart), each a follicle ring (label 1, 8% of
    the minor semi-axis thick, at least 2 px) around nurse cells (label 2)
    and an oocyte at one end of the major axis (label 3), on background
    (label 0); the image is each class's :data:`OVARY_COLOURS` plus
    N(0, ``noise``), clipped to [0, 1].  Eggs are drawn from
    ``np.random.default_rng(rand_seed)`` until ``n_eggs`` fit (at most 1000
    tries).

    :returns: (image (H, W, 3) float32, segm (H, W) int32, egg centres
        (E, 2) float64 (row, col))
    """
    rng = np.random.default_rng(rand_seed)
    h, w = size
    scale = min(h, w)
    eggs = []
    for _ in range(1000):
        if len(eggs) == n_eggs:
            break
        a = rng.uniform(0.12, 0.23) * scale
        b = a * rng.uniform(0.65, 0.95)
        theta = rng.uniform(0.0, np.pi)
        margin = a + 2.0
        if 2 * margin >= min(h, w):
            continue
        cy = rng.uniform(margin, h - margin)
        cx = rng.uniform(margin, w - margin)
        if any(np.hypot(cy - e[0], cx - e[1]) < a + e[2] + 0.03 * scale
               for e in eggs):
            continue
        eggs.append((cy, cx, a, b, theta))
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    segm = np.zeros((h, w), dtype=np.int32)
    for cy, cx, a, b, theta in eggs:
        dy, dx = yy - cy, xx - cx
        along = dy * np.cos(theta) + dx * np.sin(theta)   # major axis
        across = -dy * np.sin(theta) + dx * np.cos(theta)
        inside = (along / a) ** 2 + (across / b) ** 2 <= 1
        thick = max(2.0, 0.08 * b)
        inner = ((along / (a - thick)) ** 2
                 + (across / (b - thick)) ** 2 <= 1)
        oocyte = (((along / a - 0.45) / 0.5) ** 2
                  + (across / b / 0.8) ** 2 <= 1)
        segm[inside] = 2
        segm[inside & oocyte] = 3
        segm[inside & ~inner] = 1
    img = np.asarray(OVARY_COLOURS, np.float32)[segm]
    img += rng.normal(0.0, noise, img.shape).astype(np.float32)
    centres = np.array([(e[0], e[1]) for e in eggs], dtype=np.float64)
    return np.clip(img, 0, 1), segm, centres.reshape(-1, 2)
