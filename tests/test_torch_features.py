"""The port's colour conversions, per-superpixel statistics and colour
descriptors vs the JAX package on the CPU, and the ``grid_reduce`` kernel's
plain twin vs the Pallas kernel in interpret mode."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pyimsegm_tpu import descriptors as jdesc
from pyimsegm_tpu.ops import color as jcolor
from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops import segment_stats as jstats
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import descriptors as tdesc
from pyimsegm_tpu_torch.ops import color as tcolor
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops import grid_cuda
from pyimsegm_tpu_torch.ops import segment_stats as tstats
from pyimsegm_tpu_torch.ops import slic as tslic

from torch_threads import one_torch_thread  # noqa: F401

SHAPE, SP = (120, 160), 15
FLAGS = ('mean', 'std', 'energy', 'median', 'meanGrad')


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope='module')
def scene():
    """A synthetic colour image in [0, 1] and its JAX SLIC labels."""
    img = sample_color_image_rand_segment(SHAPE, 3, rand_seed=4)[0]
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    cfg = jslic.slic_config(*SHAPE, SP)
    labels = np.asarray(jslic._slic_segment_xla(
        jnp.asarray(img), cfg, jslic.compactness_from_regul(SP, 0.2)))
    return img, labels, cfg


@pytest.mark.parametrize('space', ['xyz', 'lab', 'luv', 'hsv', 'hed', 'rgb'])
def test_colour_conversion_matches_jax(scene, space):
    img = scene[0]
    rng = np.random.default_rng(0)
    # grays (hsv's delta == 0 branch) and exact zeros (luv, hed clamps)
    img = np.concatenate([img, np.repeat(rng.random((4, SHAPE[1], 1)), 3, -1),
                          np.zeros((2, SHAPE[1], 3))]).astype(np.float32)
    want = np.asarray(jcolor.convert_img_color_from_rgb(jnp.asarray(img),
                                                        space))
    got = tcolor.convert_img_color_from_rgb(_t(img), space).numpy()
    # Lab's a, b and Luv's u, v are differences of O(1) terms scaled by up
    # to 500: where they cancel, the error is relative to the scale
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_rgb2gray_and_unknown_space(scene):
    img = scene[0]
    np.testing.assert_allclose(tcolor.rgb2gray(_t(img)).numpy(),
                               np.asarray(jcolor.rgb2gray(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tcolor.convert_img_color_from_rgb(_t(img), 'cmyk')


def test_segment_moments_median_gradient_match_jax(scene):
    img, labels, cfg = scene
    k = cfg.n_segments
    vals, ids = img.reshape(-1, 3), labels.reshape(-1)
    ref = jstats.segment_mean_std_energy(jnp.asarray(vals), jnp.asarray(ids),
                                         k)
    out = tstats.segment_mean_std_energy(_t(vals), _t(ids), k)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tstats.segment_median(_t(vals), _t(ids), k + 3).numpy(),
        np.asarray(jstats.segment_median(jnp.asarray(vals), jnp.asarray(ids),
                                         k + 3)))
    np.testing.assert_allclose(
        tstats.image_gradient_sum(_t(img[..., 1])).numpy(),
        np.asarray(jstats.image_gradient_sum(jnp.asarray(img[..., 1]))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('grid', [True, False], ids=['grid', 'generic'])
def test_compute_channel_statistics_matches_jax(scene, grid):
    img, labels, cfg = scene
    k = cfg.n_segments
    ids = labels.reshape(-1)
    ref = jstats.compute_channel_statistics(
        jnp.asarray(img), jnp.asarray(ids), k, FLAGS,
        grid_ctx=(jnp.asarray(labels), cfg) if grid else None)
    out = tstats.compute_channel_statistics(
        _t(img), _t(ids), k, FLAGS,
        grid_ctx=(_t(labels), tslic.slic_config(*SHAPE, SP)) if grid else None)
    assert out.shape == ref.shape == (k, 15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert tstats.statistic_names(['a', 'b'], FLAGS) == \
        jstats.statistic_names(['a', 'b'], FLAGS)


@pytest.mark.parametrize('spec', [
    {'color': FLAGS},
    {'color_hsv': ('mean', 'median', 'meanGrad')},
    {'color': ('std',), 'color_lab': ('mean', 'energy')},
], ids=['all_flags', 'hsv', 'rgb_and_lab'])
def test_colour_descriptors_match_jax(scene, spec):
    img, labels, cfg = scene
    k = cfg.n_segments
    fj, nj = jdesc.compute_selected_features_img2d(
        jnp.asarray(img), jnp.asarray(labels.reshape(-1)), k, spec,
        grid_ctx=(jnp.asarray(labels), cfg))
    ft, nt = tdesc.compute_selected_features_img2d(
        _t(img), _t(labels.reshape(-1)), k, spec,
        grid_ctx=(_t(labels), tslic.slic_config(*SHAPE, SP)))
    assert nt == nj
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-4)


def test_gray_descriptors_match_jax(scene):
    img, labels, cfg = scene
    gray = img.mean(-1)
    spec = {'color': ('mean', 'median'), 'color_x': ('std',)}
    fj, nj = jdesc.compute_selected_features_gray2d(
        jnp.asarray(gray), jnp.asarray(labels.reshape(-1)), cfg.n_segments,
        spec, grid_ctx=(jnp.asarray(labels), cfg))
    ft, nt = tdesc.compute_selected_features_img2d(
        _t(gray), _t(labels.reshape(-1)), cfg.n_segments, spec,
        grid_ctx=(_t(labels), tslic.slic_config(*SHAPE, SP)))
    assert nt == nj
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('key', ['tLM', 'tLM_short', 'tGabor', 'tLBP'])
def test_texture_keys_raise(scene, key):
    """Texture of gray images is ported (this test held its former raise):
    with a colour key, the LM keys give JAX's ``tLM_<filter>_<flag>``
    features (names equal, values within rtol 1e-5 + 1e-4), with the grid
    reduce and without, and the Gabor and LBP keys are left out as JAX
    leaves them, but for the grid reduce, where JAX takes them alone as a
    volume and raises, and so does the port; without a colour key they
    raise alone."""
    img, labels, cfg = scene
    gray = img[..., 0]
    spec = {'color': ('mean', 'std'), key: ('mean', 'energy', 'meanGrad')}
    for grid in (False, True):
        args = dict(grid_ctx=(jnp.asarray(labels), cfg) if grid else None)
        targs = dict(grid_ctx=(_t(labels), tslic.slic_config(*SHAPE, SP))
                     if grid else None)
        if grid and not key.startswith('tLM'):
            for desc, conv, kw in ((jdesc, jnp.asarray, args),
                                   (tdesc, _t, targs)):
                with pytest.raises(ValueError):
                    desc.compute_selected_features_gray2d(
                        conv(gray), conv(labels.reshape(-1)),
                        cfg.n_segments, spec, **kw)
            continue
        fj, nj = jdesc.compute_selected_features_gray2d(
            jnp.asarray(gray), jnp.asarray(labels.reshape(-1)),
            cfg.n_segments, spec, **args)
        ft, nt = tdesc.compute_selected_features_gray2d(
            _t(gray), _t(labels.reshape(-1)), cfg.n_segments, spec, **targs)
        assert nt == nj
        assert len(nt) == (2 + 3 * len(tdesc._get_bank(
            'short' if key == 'tLM_short' else 'normal').names)
            if key.startswith('tLM') else 2)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                                   atol=1e-4)
    if not key.startswith('tLM'):
        for desc in (jdesc, tdesc):
            with pytest.raises(ValueError):
                desc.compute_selected_features_gray2d(
                    (jnp.asarray if desc is jdesc else _t)(gray),
                    (jnp.asarray if desc is jdesc else _t)(
                        labels.reshape(-1)), cfg.n_segments,
                    {key: ('mean',)})


def _damaged(labels, cfg, seed):
    """Labels with -2 holes and ids outside their pixel's 3x3 window."""
    rng = np.random.default_rng(seed)
    bad = labels.copy()
    flat = bad.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[idx[: len(idx) // 2]] = -2
    far = (labels.reshape(-1)[idx[len(idx) // 2:]] + 3 * cfg.grid_w + 3) \
        % cfg.n_segments
    flat[idx[len(idx) // 2:]] = far
    return bad


@pytest.mark.parametrize('f', [1, 3, 9])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('damage', [False, True], ids=['slic', 'damaged'])
def test_grid_reduce_twin_matches_pallas_interpret(scene, f, dtype, damage):
    from pyimsegm_tpu.ops import grid_pallas
    _, labels, cfg = scene
    if damage:
        labels = _damaged(labels, cfg, f)
    data = np.random.default_rng(f).normal(size=SHAPE + (f,)).astype(
        np.float32)
    jdata = jnp.asarray(data).astype(jnp.dtype(dtype))
    orig = pl.pallas_call
    calls = []

    def call(*args, **kwargs):
        kwargs['interpret'] = True
        calls.append(1)
        return orig(*args, **kwargs)

    jax.clear_caches()
    with mock.patch.object(grid_pallas.pl, 'pallas_call', call):
        ref = np.asarray(grid_pallas.grid_reduce_pallas(
            jdata, jnp.asarray(labels), cfg))
    assert calls
    tdata = _t(np.asarray(jdata.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = grid_cuda.grid_reduce(tdata, _t(labels),
                                tslic.slic_config(*SHAPE, SP))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    scale = np.abs(ref).max(axis=0, keepdims=True)
    assert (np.abs(out.numpy() - ref) <= 1e-5 * np.abs(ref) + 1e-5 * scale
            ).all()


#: a non-square shape whose width is not a multiple of 4, with partial last
#: tiles at SP
ODD_SHAPE = (57, 74)


@pytest.fixture(scope='module')
def odd_scene():
    """ODD_SHAPE's synthetic colour image and its JAX SLIC labels."""
    img = sample_color_image_rand_segment(ODD_SHAPE, 3, rand_seed=5)[0]
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    cfg = jslic.slic_config(*ODD_SHAPE, SP)
    labels = np.asarray(jslic._slic_segment_xla(
        jnp.asarray(img), cfg, jslic.compactness_from_regul(SP, 0.2)))
    return labels, cfg


def _beyond_k(labels, cfg, seed):
    """Damaged labels (``_damaged``) with ids >= K too: in the last tile
    row's window (their sums route off the grid) and far beyond it."""
    bad = _damaged(labels, cfg, seed)
    rng = np.random.default_rng(seed)
    flat = bad.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[idx[: len(idx) // 2]] = 2 ** 31 - 1
    flat[idx[len(idx) // 2:]] = cfg.n_segments + 5 * cfg.grid_w
    cols = np.arange(bad.shape[1]) // cfg.step
    bad[-2:, :] = cfg.n_segments + cols[None]
    return bad


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('damage', [False, True], ids=['slic', 'damaged'])
def test_grid_reduce_twin_odd_shape_matches_pallas_interpret(odd_scene,
                                                             dtype, damage):
    """Row 6 at F = 5 on a shape whose width is not a multiple of 4 and
    whose last tiles are partial, against the Pallas kernel in interpret
    mode (the damaged labels also hold ids >= K)."""
    from pyimsegm_tpu.ops import grid_pallas
    labels, cfg = odd_scene
    if damage:
        labels = _beyond_k(labels, cfg, 5)
    data = np.random.default_rng(5).normal(size=ODD_SHAPE + (5,)).astype(
        np.float32)
    jdata = jnp.asarray(data).astype(jnp.dtype(dtype))
    orig = pl.pallas_call
    calls = []

    def call(*args, **kwargs):
        kwargs['interpret'] = True
        calls.append(1)
        return orig(*args, **kwargs)

    jax.clear_caches()
    with mock.patch.object(grid_pallas.pl, 'pallas_call', call):
        ref = np.asarray(grid_pallas.grid_reduce_pallas(
            jdata, jnp.asarray(labels), cfg))
    assert calls
    tdata = _t(np.asarray(jdata.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = grid_cuda.grid_reduce(tdata, _t(labels),
                                tslic.slic_config(*ODD_SHAPE, SP))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    scale = np.abs(ref).max(axis=0, keepdims=True)
    assert (np.abs(out.numpy() - ref) <= 1e-5 * np.abs(ref) + 1e-5 * scale
            ).all()


def test_grid_segment_sum_and_count_match_jax(scene):
    _, labels, cfg = scene
    lab = _damaged(labels, cfg, 7)
    tcfg = tslic.slic_config(*SHAPE, SP)
    np.testing.assert_array_equal(
        tgrid.grid_segment_count(_t(lab), tcfg).numpy(),
        np.asarray(jgrid.grid_segment_count(jnp.asarray(lab), cfg)))
    data = np.random.default_rng(1).random(SHAPE + (4,), np.float32)
    np.testing.assert_allclose(
        tgrid.grid_segment_sum(_t(data), _t(lab), tcfg).numpy(),
        np.asarray(jgrid.grid_segment_sum(jnp.asarray(data),
                                          jnp.asarray(lab), cfg)),
        rtol=1e-5, atol=1e-5)
