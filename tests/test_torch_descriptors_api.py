"""The reference-signature statistics API of the port's ``descriptors``
(the numpy_* host twins, the cython_* device twins, the statistic
dispatchers, the LM texture descriptors and the filter helpers) vs the JAX
package on the same numpy-seeded images and labels: rtol 1e-5 + atol 1e-6,
medians exact; every numpy_* twin, and the host filter responses, equal to
JAX's."""

import numpy as np
import pytest
import torch

from pyimsegm_tpu import descriptors as jdesc
from pyimsegm_tpu_torch import descriptors as tdesc

from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, empty=True):
    """(colour image, its labels, gray volume, its labels); label 5 of the
    2D map and 3 of the 3D map are empty."""
    rng = np.random.default_rng(seed)
    img = rng.random((30, 40, 3)).astype(np.float32)
    seg = np.kron(rng.integers(0, 8, (6, 8)), np.ones((5, 5), int))
    vol = rng.random((4, 20, 24)).astype(np.float32)
    seg3 = np.kron(rng.integers(0, 6, (2, 4, 4)), np.ones((2, 5, 6), int))
    if empty:
        seg[seg == 5] = 4
        seg3[seg3 == 3] = 2
    return img, seg, vol, seg3


NUMPY_TWINS = ('numpy_img2d_color_mean', 'numpy_img2d_color_energy',
               'numpy_img2d_color_std', 'numpy_img2d_color_median',
               'numpy_img3d_gray_mean', 'numpy_img3d_gray_energy',
               'numpy_img3d_gray_std', 'numpy_img3d_gray_median')


@pytest.mark.parametrize('name', NUMPY_TWINS)
def test_numpy_twins_equal_jax(name):
    img, seg, vol, seg3 = _inputs(0)
    args = (img, seg) if '2d' in name else (vol, seg3)
    np.testing.assert_array_equal(getattr(tdesc, name)(*args),
                                  getattr(jdesc, name)(*args))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('stat', ['mean', 'energy', 'std'])
@pytest.mark.parametrize('dim', ['img2d_color', 'img3d_gray'])
def test_cython_twins(dim, stat, seed):
    """Each device twin against JAX's and against its numpy twin."""
    img, seg, vol, seg3 = _inputs(seed)
    args = (img, seg) if dim == 'img2d_color' else (vol, seg3)
    name = 'cython_%s_%s' % (dim, stat)
    got = getattr(tdesc, name)(*args, device='cpu')
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, getattr(jdesc, name)(*args), **TOL)
    np.testing.assert_allclose(
        got, getattr(tdesc, 'numpy_%s_%s' % (dim, stat))(*args), rtol=1e-5,
        atol=1e-5)


def test_cython_std_ignores_means():
    img, seg, _, _ = _inputs(0)
    np.testing.assert_array_equal(
        tdesc.cython_img2d_color_std(img, seg, means=np.zeros((8, 3)),
                                     device='cpu'),
        tdesc.cython_img2d_color_std(img, seg, device='cpu'))


@pytest.mark.parametrize('flags', [('mean', 'std', 'energy', 'median',
                                    'meanGrad'), ('median',),
                                   ('energy', 'mean')])
def test_statistic_dispatchers(flags):
    img, seg, vol, seg3 = _inputs(2)
    for fn, args, kw in (
            ('compute_image2d_color_statistic', (img, seg), {}),
            ('compute_image2d_color_statistic', (img, seg),
             {'color_name': 'lab'}),
            ('compute_image3d_gray_statistic', (vol, seg3), {})):
        got, names = getattr(tdesc, fn)(*args, feature_flags=flags,
                                         device='cpu', **kw)
        want, want_names = getattr(jdesc, fn)(*args, feature_flags=flags,
                                              **kw)
        assert names == want_names and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **TOL)
        for i, name in enumerate(names):
            if name.endswith('median'):
                np.testing.assert_array_equal(got[:, i], want[:, i])


def test_texture_descriptors():
    """The 2D LM descriptor against JAX's; the 3D one against the port's
    gray-volume texture features, which ``tests/test_torch_pipeline3d.py``
    holds against JAX (a JAX compile of each takes ~17 s here)."""
    img, seg, vol, seg3 = _inputs(3)
    flags = ('mean', 'std', 'energy')
    got, names = tdesc.compute_texture_desc_lm_img2d_clr(img, seg, flags,
                                                         device='cpu')
    want, want_names = jdesc.compute_texture_desc_lm_img2d_clr(img, seg,
                                                               flags)
    assert names == want_names
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got, names = tdesc.compute_texture_desc_lm_img3d_val(
        vol, seg3, ('energy', 'mean'), 'short', device='cpu')
    ids = torch.as_tensor(seg3.ravel())
    want, want_names = tdesc._texture_features_gray3d(
        torch.as_tensor(vol), ids, int(seg3.max()) + 1, ('mean', 'energy'),
        'short')
    assert names == want_names and names[0].endswith('_mean')
    np.testing.assert_array_equal(got, torch.nan_to_num(want).numpy())


def test_filter_helpers_and_host_api():
    vals = np.linspace(-5, 5, 11)
    for order in (0, 1, 2):
        np.testing.assert_array_equal(
            tdesc.make_gaussian_filter1d(vals, 1.5, order),
            jdesc.make_gaussian_filter1d(vals, 1.5, order))
    with pytest.raises(ValueError):
        tdesc.make_gaussian_filter1d(vals, 1.5, 3)
    points = np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4))
                      ).reshape(2, -1).astype(float)
    edge = tdesc.make_edge_filter2d(1.0, 1, points, 7)
    np.testing.assert_array_equal(edge,
                                  jdesc.make_edge_filter2d(1.0, 1, points, 7))
    img, seg, vol, _ = _inputs(4)
    battery = np.stack([edge, edge.T])
    np.testing.assert_array_equal(
        tdesc.compute_img_filter_response2d(img[..., 0], battery),
        jdesc.compute_img_filter_response2d(img[..., 0], battery))
    np.testing.assert_array_equal(
        tdesc.compute_img_filter_response3d(vol, edge),
        jdesc.compute_img_filter_response3d(vol, edge))
    np.testing.assert_array_equal(tdesc.image_subtract_gauss_smooth(vol, 2.),
                                  jdesc.image_subtract_gauss_smooth(vol, 2.))
    feats = img.reshape(-1, 3)[:50]
    got, scaler = tdesc.norm_features(feats)
    want, want_scaler = jdesc.norm_features(feats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdesc.norm_features(feats, scaler)[0],
                                  jdesc.norm_features(feats,
                                                      want_scaler)[0])
    window = seg[5:12, 7:14]
    element = (np.random.default_rng(0).random((7, 7)) > 0.4).astype(int)
    np.testing.assert_array_equal(
        tdesc.cython_label_hist_seg2d(window, element, 8),
        jdesc.cython_label_hist_seg2d(window, element, 8))


def test_tensor_labels_stay_on_their_device():
    img, seg, _, _ = _inputs(5)
    got, _ = tdesc.compute_image2d_color_statistic(
        torch.as_tensor(img), torch.as_tensor(seg), ('mean',))
    want, _ = jdesc.compute_image2d_color_statistic(img, seg, ('mean',))
    np.testing.assert_allclose(got, want, **TOL)
