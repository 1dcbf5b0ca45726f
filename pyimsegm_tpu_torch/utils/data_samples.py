"""Synthetic sample images (numpy only; port of the generator in
``pyimsegm_tpu.utils.data_samples``)."""

import numpy as np


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
