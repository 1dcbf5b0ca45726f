"""The port's 3D SLIC (``pyimsegm_tpu_torch.ops.slic3d``, the plain twins of
``ops/slic3d_cuda.py``) and its grid sums and lookup, against the JAX
package on the CPU: the XLA path ``_slic3d_segment_xla`` and, once, the
Pallas kernel ``slic3d_iterate_pallas`` in interpret mode."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.ops import slic3d as jslic3d
from pyimsegm_tpu.ops.slic import compactness_from_regul
from pyimsegm_tpu_torch.ops import slic3d as tslic3d
from pyimsegm_tpu_torch.ops import slic3d_cuda
from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d

from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (8, 40, 48)
CASES = [(8, (2, 1, 1)), (7, (3, 1, 2))]
IDS = ['sp8_z2', 'sp7_z3x2']


def _volume(shape=SHAPE, seed=0):
    return sample_gray_volume_3d(shape, rand_seed=seed)[0]


def _configs(sp, spacing, shape=SHAPE):
    return (jslic3d.slic3d_config(shape, sp, spacing),
            tslic3d.slic3d_config(shape, sp, spacing),
            compactness_from_regul(sp, 0.2))


@pytest.mark.parametrize('sp,spacing', CASES, ids=IDS)
def test_prep_matches_jax(sp, spacing):
    """Config, normalised padded volume and seeds: exact."""
    vol = _volume()
    cj, ct, _ = _configs(sp, spacing)
    assert tuple(ct) == tuple(cj)
    vp_j, valid_j, c0_j, _sw = jslic3d._prep3d(jnp.asarray(vol), cj)
    vp_t, c0_t = tslic3d._prep3d(torch.as_tensor(vol), ct)
    np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_j))
    np.testing.assert_array_equal(c0_t.numpy(), np.asarray(c0_j))


def test_slic3d_segment_at_a_large_x_step_matches_jax():
    """Seed steps (4, 4, 640): a tile row of 640 voxels, beyond the shared
    memory of the kernel's unbanded layout, which takes bands of columns
    there (chip_smoke.py holds the kernel against this twin): the twin's
    labels >= 0.999 equal to JAX's XLA path."""
    shape = (4, 8, 1302)
    vol = _volume(shape, seed=3)
    cj, ct, m = _configs(640, (160, 160, 1), shape)
    assert ct.steps == (4, 4, 640)
    lj = np.asarray(jslic3d._slic3d_segment_xla(jnp.asarray(vol), cj, m))
    lt = tslic3d.slic3d_segment(torch.as_tensor(vol), ct, m)
    assert tuple(lt.shape) == shape
    assert (lt.numpy() == lj).mean() >= 0.999


@pytest.mark.parametrize('sp,spacing', CASES, ids=IDS)
def test_slic3d_segment_matches_jax(sp, spacing):
    """The whole schedule (9 rounds + labels) on the structured volume:
    labels >= 0.999 equal (the sums are added in another order than
    XLA's)."""
    vol = _volume(seed=1)
    cj, ct, m = _configs(sp, spacing)
    lj = np.asarray(jslic3d._slic3d_segment_xla(jnp.asarray(vol), cj, m))
    lt = tslic3d.slic3d_segment(torch.as_tensor(vol), ct, m)
    assert lt.dtype == torch.int32 and tuple(lt.shape) == SHAPE
    assert (lt.numpy() == lj).mean() >= 0.999


@pytest.mark.parametrize('n_iter', [1, 2])
def test_labels_pass_exact_given_the_same_centers(n_iter):
    """n_iter = 1 is the labels pass on the seeds alone, n_iter = 2 one
    partials pass and update before it: exact."""
    vol = _volume(seed=2)
    cj, ct, m = _configs(8, (2, 1, 1))
    lj = np.asarray(jslic3d._slic3d_segment_xla(jnp.asarray(vol), cj, m,
                                                n_iter=n_iter))
    vp, c0 = tslic3d._prep3d(torch.as_tensor(vol), ct)
    if n_iter == 2:
        c0 = slic3d_cuda._update3d_plain(
            slic3d_cuda.slic3d_partials(vp, c0, m, ct), c0)
    lt = slic3d_cuda.slic3d_labels(vp, c0, m, ct)
    np.testing.assert_array_equal(lt.numpy()[:8, :40, :48], lj)


def test_partials_are_the_segment_sums_of_the_labels():
    """Routed partials = per-label sums of [v, z, y, x, 1] over the valid
    voxels of the labels the same centres give (rtol 1e-5: the sums are
    added in another order)."""
    vol = _volume((10, 37, 45), seed=3)
    _, ct, m = _configs(8, (2, 1, 1), shape=vol.shape)
    vp, c0 = tslic3d._prep3d(torch.as_tensor(vol), ct)
    sums = slic3d_cuda.combine_sums3d(slic3d_cuda.slic3d_partials(vp, c0, m,
                                                                  ct))
    lab = slic3d_cuda.slic3d_labels(vp, c0, m, ct)[:10, :37, :45].numpy()
    zz, yy, xx = np.meshgrid(*[np.arange(n) for n in vol.shape],
                             indexing='ij')
    vn = vp.numpy()[:10, :37, :45]
    k = ct.n_segments
    want = np.stack([np.bincount(lab.ravel(), weights=w.ravel(), minlength=k)
                     for w in (vn, zz, yy, xx, np.ones_like(vn))], axis=-1)
    np.testing.assert_allclose(sums.reshape(k, 5).numpy(), want, rtol=1e-5,
                               atol=1e-4)
    new = slic3d_cuda._update3d_plain(slic3d_cuda.slic3d_partials(
        vp, c0, m, ct), c0).reshape(k, 4).numpy()
    cnt = want[:, 4:]
    np.testing.assert_allclose(
        new, np.where(cnt > 0, want[:, :4] / np.maximum(cnt, 1),
                      c0.reshape(k, 4).numpy()), rtol=1e-5)


def _slic_labels(shape, seed):
    """Supervoxel labels of the port's twin (equal to the XLA path's, see
    above) and both configs, at sp_size 8, spacing (2, 1, 1)."""
    vol = _volume(shape, seed=seed)
    cj, ct, m = _configs(8, (2, 1, 1), shape=shape)
    return tslic3d.slic3d_segment(torch.as_tensor(vol), ct, m).numpy(), cj, ct


def _damaged(labels, cfg, seed):
    """SLIC labels with -2, out-of-window and beyond-K ids mixed in."""
    rng = np.random.default_rng(seed)
    lab = labels.copy()
    pick = rng.random(lab.shape)
    lab[pick < 0.02] = -2
    lab[(pick >= 0.02) & (pick < 0.04)] = rng.integers(
        0, cfg.n_segments, int(((pick >= 0.02) & (pick < 0.04)).sum()))
    lab[(pick >= 0.04) & (pick < 0.05)] = cfg.n_segments + 3
    return lab


@pytest.mark.parametrize('damaged', [False, True], ids=['slic', 'damaged'])
def test_grid3d_segment_sum_matches_jax(damaged):
    lab, cj, ct = _slic_labels((10, 37, 45), 4)
    if damaged:
        lab = _damaged(lab, cj, 5)
    rng = np.random.default_rng(6)
    data = rng.normal(size=lab.shape + (3,)).astype(np.float32)
    want = np.asarray(jslic3d.grid3d_segment_sum(jnp.asarray(data),
                                                 jnp.asarray(lab), cj))
    got = tslic3d.grid3d_segment_sum(torch.as_tensor(data),
                                     torch.as_tensor(lab), ct).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    counts, centers = tslic3d.grid3d_geometry(torch.as_tensor(lab), ct)
    ones = jnp.ones(lab.shape + (1,), jnp.float32)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(
        jslic3d.grid3d_segment_sum(ones, jnp.asarray(lab), cj))[:, 0])
    assert centers.shape == (ct.n_segments, 3)


@pytest.mark.parametrize('damaged', [False, True], ids=['slic', 'damaged'])
def test_grid3d_lookup_matches_jax(damaged):
    lab, cj, ct = _slic_labels((10, 37, 45), 7)
    if damaged:
        lab = _damaged(lab, cj, 8)
    rng = np.random.default_rng(9)
    for table in (rng.random((cj.n_segments, 2)).astype(np.float32),
                  rng.integers(0, 5, cj.n_segments).astype(np.int32)):
        want = np.asarray(jslic3d.grid3d_lookup(jnp.asarray(table),
                                                jnp.asarray(lab), cj))
        got = tslic3d.grid3d_lookup(torch.as_tensor(table),
                                    torch.as_tensor(lab), ct).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pallas_kernel_interpret_agrees_with_twin():
    """``slic3d_iterate_pallas`` in interpret mode (its dot-product scoring
    is not the XLA path's, so >= 0.99) against the port's twin."""
    from jax.experimental import pallas as pl
    from pyimsegm_tpu.ops import slic3d_pallas as sp3
    vol = np.random.default_rng(1).random((12, 48, 64), dtype=np.float32)
    cj, ct, m = _configs(8, (2, 1, 1), shape=vol.shape)
    orig_call = pl.pallas_call
    n_calls = [0]

    def interpret_call(*a, **k):
        n_calls[0] += 1
        return orig_call(*a, **dict(k, interpret=True))

    jax.clear_caches()
    with mock.patch.dict(os.environ, {'PYIMSEGM_SLIC3D_PALLAS': '1'}), \
            mock.patch('pyimsegm_tpu.ops.slic._pallas_available',
                       lambda: True), \
            mock.patch.object(sp3.pl, 'pallas_call', interpret_call):
        lp = np.asarray(jslic3d.slic3d_segment(jnp.asarray(vol), cj, m))
    assert n_calls[0] > 0
    lt = tslic3d.slic3d_segment(torch.as_tensor(vol), ct, m).numpy()
    assert (lp == lt).mean() >= 0.99


def test_segment_slic_img3d_gray_matches_jax():
    from pyimsegm_tpu.ops.slic3d import segment_slic_img3d_gray as jseg
    from pyimsegm_tpu_torch import superpixels as tsp
    vol = _volume(seed=10)
    lj = jseg(vol, sp_size=8, relative_compact=0.3, space=(2, 1, 1))
    lt = tsp.segment_slic_img3d_gray(vol, sp_size=8, relative_compact=0.3,
                                     space=(2, 1, 1), device='cpu')
    assert lt.dtype == np.int32 and (lt == lj).mean() >= 0.999
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tsp.segment_slic_img3d_gray(vol, sp_size=8)



#: a shape that is no multiple of the steps (4, 8, 8) in any axis, and the
#: seed given a value far beyond the volume's, so that no voxel takes it
ODD_SHAPE, EMPTY_SEED = (10, 45, 63), (1, 2, 3)


def _interpret_calls(sp3):
    """A pallas_call that runs in interpret mode and counts its calls."""
    from jax.experimental import pallas as pl
    orig_call = pl.pallas_call
    n_calls = [0]

    def interpret_call(*a, **k):
        n_calls[0] += 1
        return orig_call(*a, **dict(k, interpret=True))

    jax.clear_caches()
    return mock.patch.object(sp3.pl, 'pallas_call', interpret_call), n_calls


def test_pallas_iterate_interpret_empty_cluster_odd_shape():
    """``slic3d_iterate_pallas`` in interpret mode against the port's twin at
    an odd shape, from seeds of which one (v = 1e6) wins no voxel: its
    cluster stays empty through every round in both (it keeps its centre),
    and the labels agree on >= 0.99 of the voxels (the kernel's dot-product
    scoring is not the XLA path's)."""
    from pyimsegm_tpu.ops import slic3d_pallas as sp3
    vol = _volume(ODD_SHAPE, seed=11)
    cj, ct, m = _configs(8, (2, 1, 1), shape=ODD_SHAPE)
    assert all(d % s for d, s in zip(ODD_SHAPE, ct.steps))
    vp_j, _valid, c0_j, sw = jslic3d._prep3d(jnp.asarray(vol), cj)
    c0 = np.array(c0_j)
    c0[EMPTY_SEED + (0,)] = 1e6
    scales = jnp.asarray(cj.spacing, jnp.float32) * jnp.sqrt(
        sw * jnp.float32(m) ** 2)
    patch, n_calls = _interpret_calls(sp3)
    with patch:
        lp = np.asarray(sp3.slic3d_iterate_pallas(vp_j, jnp.asarray(c0),
                                                  scales, cj, 10))
    assert n_calls[0] > 0
    vp_t, _ = tslic3d._prep3d(torch.as_tensor(vol), ct)
    lt = slic3d_cuda.slic3d_iterate(vp_t, torch.as_tensor(c0), m, ct,
                                    10).numpy()[:10, :45, :63]
    gz, gy, gx = ct.grid
    empty = (EMPTY_SEED[0] * gy + EMPTY_SEED[1]) * gx + EMPTY_SEED[2]
    assert not (lt == empty).any() and not (lp == empty).any()
    assert (lp == lt).mean() >= 0.99


def test_combine_sums3d_matches_jax_combine_order():
    """The twin's update (``combine_sums3d``, then the division) equals the
    centres that ``slic3d_iterate_pallas`` makes from the same partials with
    its own ``combine``, bit for bit: the 27 offsets are added in the same
    order.  The passes are replaced by stubs that return the partials and
    record the centres of the labels pass."""
    from pyimsegm_tpu.ops import slic3d_pallas as sp3
    cj, ct, _ = _configs(8, (2, 1, 1), shape=ODD_SHAPE)
    gz, gy, gx = ct.grid
    rng = np.random.default_rng(12)
    part = rng.normal(size=(gz, gy, gx, 27, 5)).astype(np.float32)
    part[..., 4] = rng.integers(0, 4, size=part.shape[:4])
    for o, off in enumerate(tslic3d.OFFSETS3):    # seed EMPTY_SEED: empty
        tile = tuple(e - d for e, d in zip(EMPTY_SEED, off))
        if all(0 <= i < n for i, n in zip(tile, ct.grid)):
            part[tile + (o,)] = 0.0
    part[..., :4] *= rng.random(size=part.shape[:4] + (1,)) > 0.2
    c0 = rng.normal(size=(gz, gy, gx, 4)).astype(np.float32)
    # (gz, gy, gx, 27, 8) -> the kernel's (gz, gy, 216, gx) layout
    part8 = np.concatenate([part, np.zeros(part.shape[:4] + (3,),
                                           np.float32)], axis=-1)
    laid = part8.transpose(0, 1, 3, 4, 2).reshape(gz, gy, 216, gx)
    seen = []

    def stub(vol4, centers, scales, cfg, want_labels):
        if not want_labels:
            return jnp.asarray(laid)
        seen.append(np.asarray(centers))
        return jnp.zeros((gz, gy, ct.steps[0] * ct.steps[1], cfg.pad[2]),
                         jnp.int32)

    vp = jnp.zeros(cj.pad, jnp.float32)
    with mock.patch.object(sp3, '_pass3d', stub):
        sp3.slic3d_iterate_pallas(vp, jnp.asarray(c0), jnp.ones(3), cj, 2)
    want = seen[0]
    got = slic3d_cuda._update3d_plain(torch.as_tensor(part),
                                      torch.as_tensor(c0)).numpy()
    np.testing.assert_array_equal(got, want)
    sums = slic3d_cuda.combine_sums3d(torch.as_tensor(part)).numpy()
    assert sums[EMPTY_SEED][4] == 0 and (sums[..., 4] > 0).any()
    np.testing.assert_array_equal(got[EMPTY_SEED], c0[EMPTY_SEED])
