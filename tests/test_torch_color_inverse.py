"""The port's inverse colour conversions (``pyimsegm_tpu_torch.ops.color``)
vs the JAX package on the CPU: each inverse on the same input within 1e-5
absolute, and the round trip sRGB -> space -> sRGB within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.ops import color as jcolor
from pyimsegm_tpu_torch.ops import color as tcolor
from pyimsegm_tpu_torch.utils.data_samples import \
    sample_color_image_rand_segment

from torch_threads import one_torch_thread  # noqa: F401

SPACES = ('rgb', 'xyz', 'lab', 'luv', 'hsv', 'hed')


def _rgb(seed):
    """A noisy colour image with black, white and gray pixels (the guards
    of luv at L = 0 and of hsv at zero saturation)."""
    img = sample_color_image_rand_segment((48, 64), 3, rand_seed=seed)[0]
    img[0, :4] = 0.0
    img[1, :4] = 1.0
    img[2, :4] = 0.5
    return img


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('space', SPACES)
def test_inverse_matches_jax(space, seed):
    """The inverse of both packages on JAX's forward image."""
    src = np.array(jcolor.convert_img_color_from_rgb(
        jnp.asarray(_rgb(seed)), space))
    want = np.asarray(jcolor.convert_img_color_to_rgb(jnp.asarray(src),
                                                      space))
    got = tcolor.convert_img_color_to_rgb(torch.as_tensor(src), space)
    assert got.dtype == torch.float32 and got.shape == src.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('space', SPACES)
def test_round_trip(space):
    rgb = torch.as_tensor(_rgb(2))
    back = tcolor.convert_img_color_to_rgb(
        tcolor.convert_img_color_from_rgb(rgb, space), space)
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), rtol=0, atol=1e-4)


def test_hsv_every_sextant():
    """Hues across all six sextants, the wrap at h = 1 included."""
    h = np.linspace(0.0, 1.0, 61, dtype=np.float32)
    hsv = np.stack([h, np.full_like(h, 0.7), np.full_like(h, 0.9)], -1)
    want = np.asarray(jcolor.hsv2rgb(jnp.asarray(hsv)))
    got = tcolor.hsv2rgb(torch.as_tensor(hsv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inverse_matrices_and_names():
    np.testing.assert_array_equal(tcolor._XYZ2RGB,
                                  np.asarray(jcolor._XYZ2RGB))
    np.testing.assert_array_equal(tcolor._HED_RGB,
                                  np.asarray(jcolor._HED_RGB))
    assert sorted(tcolor.CONVERT_TO_RGB) == sorted(jcolor.CONVERT_TO_RGB)
    with pytest.raises(ValueError, match='unknown color space'):
        tcolor.convert_img_color_to_rgb(torch.zeros(2, 2, 3), 'cmyk')
