"""The port's ellipse fitting vs the JAX package on the CPU: the geometry
helpers, the conic fit, the batched criterion and residuals, RANSAC under
one ``np.random.seed``, the boundary-point preparations and the object map
of ``add_overlap_ellipse``; then the committed 647x1024 fixture that
``chip_smoke.py`` holds the card to.

The trials are drawn by ``np.random.choice`` and fitted in float64 on the
host, so with equal boundary points they are bit-equal; only the f32
criterion (its argmin at near ties) and the f32 residuals (the inlier set
at the threshold) can differ.  Bars: geometry, boundary points and the
SLIC centres exact; criteria within rtol 1e-5; residuals within 1e-4 px;
RANSAC parameters within 1e-6 relative where the inlier sets agree;
object maps equal on >= 0.999 of the pixels."""

import os
import sys

import numpy as np
import pytest

from pyimsegm_tpu import ellipse_fitting as jell
from pyimsegm_tpu_torch import ellipse_fitting as tell
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
from make_torch_port_fixture import (CENTER_TEST_SEED, ELL_INLIERS,  # noqa
                                     ELL_OVERLAP, ELL_REGUL, ELL_SLIC,
                                     ELL_THR, ELL_TRIALS, N_EGGS,
                                     OUT_CENTERS, OVARY, TABLE_PROB)

SIZE = (160, 256)
PARAMS_BAR, MAP_BAR = 1e-6, 0.999


@pytest.fixture(scope='module')
def scene():
    return sample_ovary_scene(SIZE, 2, rand_seed=3)


@pytest.fixture(scope='module')
def slic_points(scene):
    """``get_slic_points_labels`` of both packages (gray SLIC of the
    segmentation at sp 8): equal centres and labels."""
    _, segm, _ = scene
    want = jell.get_slic_points_labels(segm, slic_size=8, slic_regul=0.1)
    got = tell.get_slic_points_labels(segm, slic_size=8, slic_regul=0.1,
                                      device='cpu')
    return got, want


def test_geometry_and_conic_fit():
    """Inside mask, fill and perimeter coordinates, the conic fit and the
    model's ``predict_xy``: exactly JAX's."""
    params = (20.5, 30.0, 12.0, 16.0, np.deg2rad(30))
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    pts = jell.EllipseModelSegm().predict_xy(t, params)
    np.testing.assert_array_equal(tell.EllipseModelSegm().predict_xy(
        t, params), pts)
    grid = np.stack(np.meshgrid(np.arange(40), np.arange(50)), -1)
    grid = grid.reshape(-1, 2)
    np.testing.assert_array_equal(tell.ellipse_inside_mask(grid, params),
                                  jell.ellipse_inside_mask(grid, params))
    for fn in ('ellipse_fill_coords', 'ellipse_perimeter_coords'):
        for got, want in zip(getattr(tell, fn)(*params, shape=(30, 40)),
                             getattr(jell, fn)(*params, shape=(30, 40))):
            np.testing.assert_array_equal(got, want)
    noisy = pts + np.random.default_rng(0).normal(0, 0.3, pts.shape)
    np.testing.assert_array_equal(tell._fit_conic(noisy),
                                  jell._fit_conic(noisy))
    assert tell._fit_conic(pts[:4]) is None
    model = tell.EllipseModelSegm(device='cpu')
    assert model.estimate(noisy)
    # f32 samples of the ellipse at coordinates < 50 (the angles rounded
    # another way than XLA's linspace): within 1e-4 px
    np.testing.assert_allclose(
        model.residuals(noisy),
        jell.EllipseModelSegm.residuals(model, noisy), rtol=0, atol=1e-4)


def test_criterion_values():
    """The reference's criterion doctest values, and the port's values
    within rtol 1e-5 of JAX's, for a table given as one row or two."""
    seg = np.zeros((10, 15), dtype=int)
    r, c = np.meshgrid(range(seg.shape[1]), range(seg.shape[0]))
    pts = np.array([r.ravel(), c.ravel()]).T
    weights = np.ones(seg.size)
    tm, jm = tell.EllipseModelSegm(device='cpu'), jell.EllipseModelSegm()
    tm.params = jm.params = [4, 7, 3, 6, np.deg2rad(10)]
    for box, value in (((4, 5, 6, 8), 87.888), ((2, 7, 4, 11), 17.577),
                       ((1, 9, 1, 14), -70.311)):
        seg[box[0]:box[1], box[2]:box[3]] = 1
        for table in ([[0.1, 0.9]], [[0.1, 0.9], [0.9, 0.1]]):
            got = tm.criterion(pts, weights, seg.ravel(), table)
            assert got == pytest.approx(value, abs=0.1)
            assert got == pytest.approx(
                jm.criterion(pts, weights, seg.ravel(), table), rel=1e-5)
    with pytest.raises(ValueError):
        tm.criterion(pts[:3], weights, seg.ravel())


def test_ransac_and_object_map(scene, slic_points):
    """Per centre: ray-edge boundary points exact, RANSAC under one
    ``np.random.seed`` with the parameters within 1e-6 relative (the
    inlier sets equal), then the object map of ``add_overlap_ellipse``."""
    _, segm, centres = scene
    (st, pt, lt), (sj, pj, lj) = slic_points
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(lt, lj)
    assert (st == sj).mean() >= 0.999
    weights = np.bincount(sj.ravel())
    bt = tell.prepare_boundary_points_ray_edge(segm, centres, device='cpu')
    bj = jell.prepare_boundary_points_ray_edge(segm, centres)
    obj_t = obj_j = np.zeros(segm.shape, int)
    for i, (pts_t, pts_j) in enumerate(zip(bt, bj)):
        np.testing.assert_array_equal(pts_t, pts_j)
        np.random.seed(0)
        mt, it = tell.ransac_segm(pts_t, tell.EllipseModelSegm, pt, weights,
                                  lt, [TABLE_PROB], 0.35, 3, max_trials=30,
                                  device='cpu')
        np.random.seed(0)
        mj, ij = jell.ransac_segm(pts_j, jell.EllipseModelSegm, pj, weights,
                                  lj, [TABLE_PROB], 0.35, 3, max_trials=30)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(mt.params, mj.params, rtol=PARAMS_BAR)
        assert mt.device == 'cpu'
        obj_t = tell.add_overlap_ellipse(obj_t, mt.params, i + 1, 0.45)
        obj_j = jell.add_overlap_ellipse(obj_j, mj.params, i + 1, 0.45)
    assert (obj_t == obj_j).mean() >= MAP_BAR
    assert obj_t.max() == len(centres)
    rejected = tell.add_overlap_ellipse(obj_t, mt.params, 9, 0.45)
    np.testing.assert_array_equal(rejected, obj_t)


@pytest.mark.parametrize('fn', ['prepare_boundary_points_ray_join',
                                'prepare_boundary_points_ray_mean',
                                'prepare_boundary_points_ray_dist',
                                'prepare_boundary_points_close'])
def test_boundary_point_preparations(scene, fn):
    """The other boundary-point preparations: exactly JAX's."""
    _, segm, centres = scene
    # the close-points route at the SLIC of ``slic_points`` (one compile)
    kw = ({'sp_size': 8, 'relative_compact': 0.1}
          if fn == 'prepare_boundary_points_close' else {})
    got = getattr(tell, fn)(segm, centres, device='cpu', **kw)
    want = getattr(jell, fn)(segm, centres, **kw)
    assert len(got) == len(want) == len(centres)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_and_filter(scene, slic_points):
    """The smoothed background / foreground masks and the mixed-label
    superpixel centres: exactly JAX's."""
    _, segm, _ = scene
    for got, want in zip(tell.split_segm_background_foreground(
            segm, device='cpu'), jell.split_segm_background_foreground(segm)):
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)
    (st, _, _), _ = slic_points
    np.testing.assert_array_equal(
        tell.filter_boundary_points(segm, st, device='cpu'),
        jell.filter_boundary_points(segm, st))


def test_committed_ellipse_fixture():
    """The ellipse chain at 647x1024 on the fixture's test scene against
    the JAX-CPU outputs that chip_smoke.py holds the card to: gray SLIC
    labels >= 0.999, boundary points exact, RANSAC parameters within 1e-6
    relative where the inlier counts agree, the object map >= 0.999."""
    with np.load(OUT_CENTERS) as npz:
        fx = {k: npz[k] for k in npz.files}
    _, segm, centres = sample_ovary_scene(OVARY, N_EGGS,
                                          rand_seed=CENTER_TEST_SEED)
    slic, points_all, labels = tell.get_slic_points_labels(
        segm, slic_size=ELL_SLIC, slic_regul=ELL_REGUL, device='cpu')
    assert (slic == fx['ell_slic']).mean() >= 0.999
    weights = np.bincount(slic.ravel())
    boundary = tell.prepare_boundary_points_ray_edge(segm, centres,
                                                     device='cpu')
    np.testing.assert_array_equal(np.concatenate(boundary), fx['ell_points'])
    np.random.seed(0)
    obj = np.zeros(segm.shape, dtype=int)
    for i, pts in enumerate(boundary):
        model, inliers = tell.ransac_segm(
            pts, tell.EllipseModelSegm, points_all, weights, labels,
            [TABLE_PROB], ELL_INLIERS, ELL_THR, max_trials=ELL_TRIALS,
            device='cpu')
        assert int(inliers.sum()) == fx['ell_inliers'][i]
        np.testing.assert_allclose(model.params, fx['ell_params'][i],
                                   rtol=PARAMS_BAR)
        obj = tell.add_overlap_ellipse(obj, model.params, i + 1,
                                       thr_overlap=ELL_OVERLAP)
    assert (obj == fx['ell_segm']).mean() >= MAP_BAR
