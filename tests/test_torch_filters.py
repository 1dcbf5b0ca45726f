"""The port's texture filter banks, background subtraction, LBP and the
texture descriptors vs the JAX package on the CPU, and row 7 (the moments
reduce) at the F of a texture battery stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import descriptors as jdesc
from pyimsegm_tpu.ops import filters as jfilt
from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import descriptors as tdesc
from pyimsegm_tpu_torch.ops import filters as tfilt
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops import slic as tslic

from torch_threads import one_torch_thread  # noqa: F401

SHAPE, SP = (64, 80), 10
BANKS = {'lm': lambda m: m.create_filter_bank_lm_2d(),
         'lm_short': lambda m: m.create_filter_bank_lm_2d(
             sigmas=m.SHORT_FILTERS_SIGMAS, nb_orient=4),
         'gabor': lambda m: m.create_filter_bank_gabor_2d()}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol_scale=1e-5):
    """rtol plus ``atol_scale`` of the largest magnitude: convolutions and
    sums are taken in another order than XLA's, and values that cancel to
    near zero keep an error relative to the scale."""
    want = np.asarray(want)
    atol = atol_scale * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


@pytest.fixture(scope='module')
def scene():
    """A synthetic colour image with noise, its enforced JAX SLIC labels
    and both configs."""
    rng = np.random.default_rng(3)
    img = sample_color_image_rand_segment(SHAPE, 3, rand_seed=2)[0]
    img = np.clip(img + rng.normal(scale=0.1, size=img.shape), 0, 1) \
        .astype(np.float32)
    cfg = jslic.slic_config(*SHAPE, SP)
    labels = jslic.slic_segment(jnp.asarray(img), cfg,
                                jslic.compactness_from_regul(SP, 0.2))
    labels = np.array(jgrid.enforce_grid_connectivity(
        labels, cfg, min_size=int(0.5 * SP * SP)))
    return img, labels, cfg, tslic.slic_config(*SHAPE, SP)


@pytest.mark.parametrize('bank', list(BANKS))
def test_banks_equal(bank):
    want, got = BANKS[bank](jfilt), BANKS[bank](tfilt)
    np.testing.assert_array_equal(got.kernels, want.kernels)
    assert got.battery_slices == want.battery_slices
    assert got.names == want.names


@pytest.mark.parametrize('bank', list(BANKS))
def test_filter_bank_raw(scene, bank):
    img = scene[0]
    want = jfilt.filter_bank_raw(jnp.asarray(img), BANKS[bank](jfilt))
    got = tfilt.filter_bank_raw(_t(img), BANKS[bank](tfilt))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    resp = tfilt.filter_bank_response(_t(img), BANKS[bank](tfilt))
    _close(resp.numpy(), jfilt.filter_bank_response(jnp.asarray(img),
                                                    BANKS[bank](jfilt)))


@pytest.mark.parametrize('shape', [SHAPE, (7, 9)])
def test_subtract_background(shape):
    img = np.random.default_rng(1).random(shape + (3,), dtype=np.float32)
    want = jfilt.subtract_background(jnp.asarray(img))
    got = tfilt.subtract_background(_t(img))
    _close(got.numpy(), want)


@pytest.mark.parametrize('uniform', [True, False])
def test_lbp_codes_exact(scene, uniform):
    img = scene[0]
    # ties between neighbours (>= sets the bit) on a quantised channel
    for ch in (img[..., 0], np.round(img[..., 1] * 4) / 4):
        want = np.asarray(jfilt.lbp_codes(jnp.asarray(ch), uniform=uniform))
        np.testing.assert_array_equal(
            tfilt.lbp_codes(_t(ch), uniform=uniform).numpy(), want)


@pytest.mark.parametrize('grid', [True, False])
@pytest.mark.parametrize('uniform', [True, False])
def test_lbp_histograms(scene, grid, uniform):
    img, labels, cfg, tcfg = scene
    k = cfg.n_segments
    fj, nj = jfilt.lbp_histogram_features(
        jnp.asarray(img), jnp.asarray(labels.ravel()), k, uniform=uniform,
        grid_ctx=(jnp.asarray(labels), cfg) if grid else None)
    ft, nt = tfilt.lbp_histogram_features(
        _t(img), _t(labels.ravel()), k, uniform=uniform,
        grid_ctx=(_t(labels), tcfg) if grid else None)
    assert nt == nj
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('spec', [
    {'tLM': ('mean', 'std', 'energy')},
    {'tLM_short': ('mean', 'std', 'energy', 'median', 'meanGrad')},
    {'tGabor': ('mean', 'energy')},
    {'tLBP': ('mean',)},
    {'color': ('mean', 'std', 'energy'), 'tGabor': ('mean', 'energy'),
     'tLBP': ('mean',)},
], ids=['tLM', 'tLM_short_all_flags', 'tGabor', 'tLBP', 'cfg2'])
@pytest.mark.parametrize('grid', [True, False], ids=['grid', 'index_add'])
def test_texture_features(scene, spec, grid):
    img, labels, cfg, tcfg = scene
    k = cfg.n_segments
    fj, nj = jdesc.compute_selected_features_color2d(
        jnp.asarray(img), jnp.asarray(labels.ravel()), k, spec,
        grid_ctx=(jnp.asarray(labels), cfg) if grid else None)
    ft, nt = tdesc.compute_selected_features_color2d(
        _t(img), _t(labels.ravel()), k, spec,
        grid_ctx=(_t(labels), tcfg) if grid else None)
    assert nt == nj
    fj, ft = np.asarray(fj), ft.numpy()
    # per column: the statistics of responses that cancel keep an error
    # relative to their column's scale
    scale = np.maximum(np.abs(fj).max(axis=0), 1e-30)
    # meanGrad differences neighbouring responses: its error is relative to
    # the response's scale, its mean column's
    for c, name in enumerate(nj):
        if name.endswith('_meanGrad'):
            mean = nj.index(name[:-len('_meanGrad')] + '_mean')
            scale[c] = max(scale[c], scale[mean])
    bar = 1e-5 * np.abs(fj) + 1e-5 * scale + 1e-7
    std = np.array([n.endswith('_std') for n in nj])
    np.testing.assert_array_less(np.abs(ft - fj)[:, ~std], bar[:, ~std])
    # std = sqrt(E[r^2] - E[r]^2) cancels where a smooth response is nearly
    # constant over a superpixel: its variance is held relative to E[r^2]
    for c in np.flatnonzero(std):
        m = nj.index(nj[c][:-len('_std')] + '_mean')
        energy = fj[:, c] ** 2 + fj[:, m] ** 2
        np.testing.assert_array_less(np.abs(ft[:, c] ** 2 - fj[:, c] ** 2),
                                     1e-5 * energy + 1e-5 * energy.max()
                                     + 1e-12)


def test_feature_names():
    spec = {'color': ('mean', 'energy'), 'tLM': ('mean', 'std'),
            'tLM_short': ('energy',)}
    for gray3d in (False, True):
        assert tdesc.feature_names(spec, gray3d) == \
            jdesc.feature_names(spec, gray3d)


@pytest.mark.parametrize('f', [18, 60])
def test_grid_geometry_moments_battery_stack(scene, f):
    """Row 7 at the F of the Gabor (18) and LM (60) battery stacks."""
    _, labels, cfg, tcfg = scene
    data = np.random.default_rng(f).normal(size=SHAPE + (f,)) \
        .astype(np.float32)
    want = np.asarray(jgrid.grid_geometry_moments(jnp.asarray(data),
                                                  jnp.asarray(labels), cfg))
    got = tgrid.grid_geometry_moments(_t(data), _t(labels), tcfg)
    assert got.shape == (cfg.n_segments, 2 * f + 3)
    # rtol 1e-5 plus 1e-5 of the channel's largest sum (the grid reduce's
    # bar): sums are added in another order
    scale = np.abs(want).max(axis=0, keepdims=True)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-5 * np.abs(want) + 1e-5 * scale + 1e-7)


@pytest.mark.parametrize('f', [1, 5, 129])
def test_grid_geometry_moments_damaged_labels(scene, f):
    """Row 7 on damaged labels: -2 holes, ids outside their pixel's 3x3
    window, and ids >= K (in the last tile row's window, and far beyond),
    against the JAX reduce; F = 129 is wider than one block of the card's
    kernel takes."""
    _, labels, cfg, tcfg = scene
    rng = np.random.default_rng(f)
    bad = labels.copy()
    flat = bad.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 25, replace=False)
    q = len(idx) // 4
    flat[idx[:q]] = -2
    flat[idx[q:2 * q]] = (flat[idx[q:2 * q]] + 3 * cfg.grid_w + 3) \
        % cfg.n_segments
    flat[idx[2 * q:3 * q]] = 2 ** 31 - 1
    flat[idx[3 * q:]] = cfg.n_segments + 5 * cfg.grid_w
    bad[-2:, :] = cfg.n_segments + np.arange(SHAPE[1])[None] // SP
    data = rng.normal(size=SHAPE + (f,)).astype(np.float32)
    want = np.asarray(jgrid.grid_geometry_moments(jnp.asarray(data),
                                                  jnp.asarray(bad), cfg))
    got = tgrid.grid_geometry_moments(_t(data), _t(bad), tcfg)
    assert got.shape == (cfg.n_segments, 2 * f + 3)
    scale = np.abs(want).max(axis=0, keepdims=True)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-5 * np.abs(want) + 1e-5 * scale + 1e-7)
