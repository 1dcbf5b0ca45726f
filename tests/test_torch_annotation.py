"""The port's annotation handling (``pyimsegm_tpu_torch.annotation``) vs
the JAX package on the same numpy-seeded images: the nearest-colour
indices (a device running minimum against JAX's argmin over the whole
distance array) are equal, ties to the first colour included, and so is
every host function."""

import os

import numpy as np
import pytest
import torch

from pyimsegm_tpu import annotation as jann
from pyimsegm_tpu_torch import annotation as tann
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401

PALETTE = list(jann.DICT_COLOURS.values())


def _coloured(seed, size=(40, 64), perturb=0.05):
    """The scene's class map in DICT_COLOURS, ``perturb`` of its pixels
    moved by up to +-60 per channel (the chip check's input, small)."""
    segm = sample_ovary_scene(size, 2, rand_seed=seed)[1]
    img = np.asarray(PALETTE, np.int32)[segm]
    rng = np.random.default_rng(seed)
    hit = rng.random(segm.shape) < perturb
    img[hit] += rng.integers(-60, 61, (int(hit.sum()), 3))
    return np.clip(img, 0, 255).astype(np.uint8), segm


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_quantisation_matches_jax(seed):
    img, _ = _coloured(seed)
    want = np.asarray(jann.image_color_2_labels(img, PALETTE))
    got = tann.image_color_2_labels(img, PALETTE, device='cpu')
    np.testing.assert_array_equal(got, want)
    want_q = jann.quantize_image_nearest_color(img, PALETTE)
    got_q = tann.quantize_image_nearest_color(torch.as_tensor(img), PALETTE)
    assert got_q.dtype == want_q.dtype == np.uint8
    np.testing.assert_array_equal(got_q, want_q)
    # default palette: the image's frequent colours
    np.testing.assert_array_equal(
        tann.image_color_2_labels(img, device='cpu'),
        np.asarray(jann.image_color_2_labels(img)))


def test_quantisation_ties_go_to_first_colour():
    """Pixels equidistant from several colours take the first of them."""
    palette = [(10, 10, 10), (30, 10, 10), (10, 30, 10), (20, 20, 10)]
    img = np.array([[[20, 10, 10], [10, 20, 10], [20, 20, 10],
                     [15, 15, 10], [30, 30, 10], [0, 0, 0]]], np.uint8)
    want = np.asarray(jann.image_color_2_labels(img, palette))
    got = tann.image_color_2_labels(img, palette, device='cpu')
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[0, 0, 3, 0, 1, 0]]


def _host_cases():
    img, segm = _coloured(0, perturb=0.0)
    lut = dict(jann.DICT_COLOURS)
    valid = np.random.default_rng(3).random(segm.shape) > 0.3
    noisy, _ = _coloured(1, perturb=0.01)
    return {
        'unique_image_colors': lambda m: m.unique_image_colors(noisy),
        'convert_img_colors_to_labels': lambda m:
            m.convert_img_colors_to_labels(img, lut),
        'convert_img_labels_to_colors': lambda m:
            m.convert_img_labels_to_colors(segm, lut),
        'image_frequent_colors': lambda m: m.image_frequent_colors(noisy,
                                                                    1e-2),
        'image_inpaint_pixels': lambda m: m.image_inpaint_pixels(
            segm.astype(float), valid),
        'quantize_image_nearest_pixel': lambda m:
            m.quantize_image_nearest_pixel(noisy, PALETTE),
    }


@pytest.mark.parametrize('name', sorted(_host_cases()))
def test_host_functions_match_jax(name):
    case = _host_cases()[name]
    got, want = case(tann), case(jann)
    if isinstance(want, dict):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_unmatched_colours_raise():
    img, _ = _coloured(0, perturb=0.05)
    with pytest.raises(ValueError):
        tann.convert_img_colors_to_labels(img, jann.DICT_COLOURS)


def test_group_frequent_colors_and_slices(tmp_path):
    """Frequent colours summed over PNG files, and the landmark grouping of
    a stage table, both as JAX gives them."""
    from PIL import Image
    paths = []
    for seed in (0, 1):
        path = os.path.join(tmp_path, 'annot_%d.png' % seed)
        Image.fromarray(_coloured(seed, perturb=0.02)[0]).save(path)
        paths.append(path)
    assert tann.group_images_frequent_colors(paths, 1e-2) == \
        jann.group_images_frequent_colors(paths, 1e-2)

    rng = np.random.default_rng(0)
    path_txt = os.path.join(tmp_path, 'info.txt')
    rows = ['\t'.join(['', 'image_path', 'stack_path', 'stage', 'slice_index']
                      + list(jann.COLUMNS_POSITION))]
    for i in range(12):
        rows.append('\t'.join(
            [str(i), 'img_%d.png' % i, 'stack_%d' % (i % 3),
             str(1 + i % 5), str(rng.integers(0, 6))]
            + [str(v) for v in rng.integers(0, 500, 6)]))
    with open(path_txt, 'w') as fp:
        fp.write('\n'.join(rows) + '\n')
    got = tann.load_info_group_by_slices(path_txt, [2, 3, 4])
    want = jann.load_info_group_by_slices(path_txt, [2, 3, 4])
    assert list(got.index) == list(want.index) and len(got) > 0
    for col in jann.COLUMNS_POSITION:
        for g, w in zip(got[col], want[col]):
            np.testing.assert_array_equal(g, w)
