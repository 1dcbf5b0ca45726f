"""The port's texture filter banks, background subtraction, LBP and the
texture descriptors vs the JAX package on the CPU, row 7 (the moments
reduce) at the F of a texture battery stack, and the host side of the
filter-bank kernel (its packing, grid, input checks and border rule)."""

import gc

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
from pyimsegm_tpu_torch.ops import filters_cuda as tfc
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


def _custom_bank(sizes, support, seed=0):
    """A bank of random L1-normalised kernels in batteries of ``sizes``."""
    k = np.random.default_rng(seed).normal(
        size=(sum(sizes), support, support)).astype(np.float32)
    k /= np.abs(k).sum(axis=(1, 2), keepdims=True)
    ends = np.cumsum(sizes)
    return tfilt.FilterBank(k, tuple(zip((ends - sizes).tolist(),
                                         ends.tolist())),
                            tuple('b%d' % i for i in range(len(sizes))))


#: batteries wider than a pass, widths padded (5, 7), runs of singles longer
#: than a pass, small batteries sharing a pass, at two supports
CUSTOM = {'mixed33': ([12, 5, 1, 1, 1, 1, 1, 2, 7, 3, 4, 17], 33),
          'mixed7': ([1, 2, 6, 1, 9], 7)}
#: (pass widths, template instance) of each bank
PACKING = {'lm': ([8, 8, 3] * 4, 2), 'lm_short': ([4, 4, 3] * 3, 1),
           'gabor': ([6] * 6, 2),
           'mixed33': ([8, 4, 6, 4, 3, 8, 3, 4, 8, 8, 1], 2),
           'mixed7': ([3, 6, 1, 8, 1], 2)}


def _bank(name):
    if name in BANKS:
        return BANKS[name](tfilt)
    return _custom_bank(*CUSTOM[name])


def _staged_index(n, start, size, radius):
    """Source index of each of ``size`` staged positions of a tile whose
    first output is ``start``: ``reflect`` of ``csrc/filter_bank.cu``
    (numpy 'symmetric' padding), position by position, as the emulation
    below stages its input."""
    out = []
    for i in range(start - radius, start - radius + size):
        while i < 0 or i >= n:
            if i < 0:
                i = -i - 1
            if i >= n:
                i = 2 * n - i - 1
        out.append(i)
    return np.array(out)


def _emulate(image, bank):
    """The kernel's arithmetic from the packed taps and table, in plain
    torch: each pass's slots correlated with the staged image, each
    battery's maximum over its slots, the clamp, the merge."""
    packed = tfc.pack_bank(bank)
    h, w, c = image.shape
    s = bank.kernels.shape[-1]
    r = s // 2
    rows = torch.as_tensor(_staged_index(h, 0, h + 2 * r, r))
    cols = torch.as_tensor(_staged_index(w, 0, w + 2 * r, r))
    x = image.permute(2, 0, 1)[:, None][:, :, rows][:, :, :, cols]
    out = torch.full((len(bank.battery_slices), h, w, c), float('nan'))
    for off, nf, ng, bat0, nbat, merge, *fb in packed.table.tolist():
        taps = packed.taps[off:off + s * s * ng].reshape(s, s, 4 * ng)
        k = torch.as_tensor(np.moveaxis(taps[..., :nf], -1, 0).copy())
        resp = torch.nn.functional.conv2d(x, k[:, None])      # (C, nf, H, W)
        fb = np.array(fb[:nf])
        for b in range(nbat):
            m = torch.amax(resp[:, fb == b], dim=1).permute(1, 2, 0)
            m = torch.clamp_max(m, tfilt.MAX_SIGNAL_RESPONSE)
            out[bat0 + b] = torch.maximum(out[bat0 + b], m) if merge else m
    return out


@pytest.mark.parametrize('bank', list(BANKS))
def test_filter_bank_wrapper_cpu_is_plain(bank):
    """On a CPU tensor the wrapper runs the plain twin and launches
    nothing."""
    img = torch.as_tensor(np.random.default_rng(5).normal(
        size=(20, 27, 3)).astype(np.float32))
    b = BANKS[bank](tfilt)
    before = tfc.LAUNCHES
    got = tfc.filter_bank(img, b)
    assert tfc.LAUNCHES == before == 0
    assert torch.equal(got, tfilt._filter_bank_raw_plain(img, b))
    assert torch.equal(tfilt.filter_bank_raw(img.double(), b), got)


@pytest.mark.parametrize('shape,grid', [
    ((2048, 3600, 3), (57, 64, 3)), ((884, 1200, 3), (19, 28, 3)),
    ((640, 768, 48), (12, 20, 48)), ((5, 7, 48), (1, 1, 48))])
@pytest.mark.parametrize('bank', list(BANKS) + list(CUSTOM))
def test_pack_bank(bank, shape, grid):
    """Pass widths, template instance, battery table and flipped taps of
    each bank, and the grid at C = 3 and C = 48."""
    b = _bank(bank)
    packed = tfc.pack_bank(b)
    widths, wide = PACKING[bank]
    table = packed.table
    assert table.dtype == np.int32 and table.shape == (len(widths),
                                                       tfc.ENTRY)
    assert table[:, 1].tolist() == widths and packed.wide == wide
    assert table[:, 2].tolist() == [(n + 3) // 4 for n in widths]
    s = b.kernels.shape[-1]
    flipped = b.kernels[:, ::-1, ::-1]
    seen = {}
    off = 0
    for row, nf in zip(table, widths):
        assert row[0] == off
        ng = row[2]
        taps = packed.taps[off:off + s * s * ng].reshape(s, s, 4 * ng)
        off += s * s * ng
        fb = row[6:]
        assert (fb[nf:] == -1).all() and (taps[..., nf:] == 0).all()
        for f in range(nf):
            if fb[f] < 0:
                assert (taps[..., f] == 0).all()
                continue
            assert 0 <= fb[f] < row[4]
            seen.setdefault(row[3] + fb[f], []).append(
                (bool(row[5]), taps[..., f]))
    assert off == len(packed.taps)
    for bi, (start, stop) in enumerate(b.battery_slices):
        got = seen[bi]
        # the passes after a battery's first 8 filters merge
        assert [m for m, _ in got] == [i >= 8 for i in range(stop - start)]
        np.testing.assert_array_equal(np.stack([t for _, t in got]),
                                      flipped[start:stop])
    assert sorted(seen) == list(range(len(b.battery_slices)))
    assert tfc.grid_dims(*shape) == grid


@pytest.mark.parametrize('bank', list(BANKS) + list(CUSTOM))
def test_pack_bank_emulated(bank):
    """The packed bank, run as the kernel runs it, gives the plain twin's
    battery maxima, on an image narrower than the halo too."""
    b = _bank(bank)
    rng = np.random.default_rng(2)
    for shape in ((23, 31, 3), (6, 40, 2)):
        img = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        _close(_emulate(img, b).numpy(),
               tfilt._filter_bank_raw_plain(img, b).numpy())


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrapper's checks take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize('case', ['float64', 'not_contiguous', 'not_3d',
                                  'support_35', 'support_even', 'empty'])
def test_filter_bank_checks_raise(case):
    img = torch.zeros((40, 50, 3))
    bank = BANKS['lm_short'](tfilt)
    tfc._check_inputs(img.as_subclass(_OnCard), bank)
    if case == 'float64':
        img = img.double()
    elif case == 'not_contiguous':
        img = img.permute(1, 0, 2)
    elif case == 'not_3d':
        img = img[..., 0]
    elif case == 'support_35':
        bank = tfilt.create_filter_bank_lm_2d(radius=17)
    elif case == 'support_even':
        bank = _custom_bank([4], 8)
    else:
        bank = bank._replace(battery_slices=bank.battery_slices + ((33, 33),))
    with pytest.raises(ValueError, match='float32|contiguous|H, W, C|odd|'
                                         'battery'):
        tfc._check_inputs(img.as_subclass(_OnCard), bank)


def test_device_bank_lives_with_the_bank():
    """The packed bank is uploaded once per bank and device, and goes when
    the bank's kernels are freed; a bank with the same kernels and other
    batteries is packed apart."""
    b = _custom_bank([3, 5], 7, seed=4)
    dev = torch.device('cpu')
    before = len(tfc._DEVICE_BANKS)
    first = tfc._device_bank(b, dev)
    assert tfc._device_bank(b, dev) is first
    assert len(tfc._DEVICE_BANKS) == before + 1
    packed = tfc.pack_bank(b)
    assert np.array_equal(first[0].numpy(), packed.taps)
    assert np.array_equal(first[1].numpy(), packed.table)
    assert first[2] == packed.wide
    other = b._replace(battery_slices=((0, 8),))
    assert tfc._device_bank(other, dev) is not first
    assert len(tfc._DEVICE_BANKS) == before + 2
    del b, other, first
    gc.collect()
    assert len(tfc._DEVICE_BANKS) == before


@pytest.mark.parametrize('n', [1, 2, 3, 15, 16, 17, 31, 32, 33, 64, 65, 97])
def test_staged_index_symmetric(n):
    """The kernel's border rule, as the emulation stages it, gives
    ``_symmetric_index`` at every tile's staged rows and columns, past the
    image's last tile too and on images narrower than the halo; every
    staged index lies in the image (the card's ``reflect`` is held to the
    plain twin on such images by ``chip_smoke.filter_bank_phases``)."""
    r = 16
    want = tslic._symmetric_index(n, r)
    for tile, extra in ((tfc.TILE_H, 2 * r), (tfc.TILE_W, 40)):
        for start in range(0, n, tile):
            got = _staged_index(n, start, tile + extra, r)
            inside = got[:len(want) - start]
            np.testing.assert_array_equal(inside,
                                          want[start:start + len(inside)])
            assert got.min() >= 0 and got.max() < n
