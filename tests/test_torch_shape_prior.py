"""The port's shape priors (``ops/shape_prior.py``) vs the JAX package on
the CPU: the normal CDF, the mixture survival tables, the batched bilinear
lookup (angles wrapped past the last row, distances beyond the table,
shifts), the one-point wrapper on the reference's doctest values, and the
all-objects cost lookup of region growing.

Bars: tables and priors within rtol 1e-5 (the f32 ``erf``, ``atan2`` and
interpolation of two libraries) plus 2.5e-7 absolute (two f32 steps at
1.0: in the tails the two ``erf`` give 0 against 9e-8, and 1 - cdf then
differs by a step); the batched lookup equal to the per-object one
exactly (the same operations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import region_growing as jrg
from pyimsegm_tpu.ops import shape_prior as jsp
from pyimsegm_tpu_torch import region_growing as trg
from pyimsegm_tpu_torch.ops import shape_prior as tsp

from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 2.5e-7

#: the reference's doctest table (tests/test_region_growing.py)
CHIST = [[1.0, 1.0, 0.8, 0.7, 0.6, 0.5, 0.3, 0.0, 0.0],
         [1.0, 1.0, 0.9, 0.8, 0.7, 0.3, 0.2, 0.2, 0.0],
         [1.0, 1.0, 1.0, 0.7, 0.6, 0.5, 0.3, 0.1, 0.1],
         [1.0, 1.0, 0.6, 0.5, 0.4, 0.3, 0.2, 0.0, 0.0]]


def _table(seed, a=15, d=120):
    """A random (A, D) survival table: non-increasing rows from 1 to ~0."""
    rng = np.random.default_rng(seed)
    steps = rng.random((a, d - 1)).astype(np.float32)
    cum = np.cumsum(steps, axis=1) / steps.sum(axis=1, keepdims=True)
    return np.concatenate([np.ones((a, 1), np.float32),
                           1.0 - cum.astype(np.float32)], axis=1)


def test_norm_cdf_matches_jax():
    x = np.linspace(-50, 400, 2001, dtype=np.float32)
    for mean, std in ((0.0, 1.0), (100.0, 20.0), (37.5, 3.25)):
        got = tsp.norm_cdf(torch.as_tensor(x), mean, std).numpy()
        want = np.asarray(jsp.norm_cdf(jnp.asarray(x), mean, std))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('case', [
    (np.array([[1, 2]]), np.array([[1.5, 0.5], [0.5, 1]]), np.array([0.7]),
     6),
    ('random', 3, 15), ('random', 1, 24),
], ids=['doctest', 'mixture3', 'single24'])
def test_cumulative_distrib_matches_jax(case):
    """Random mixtures up to ``max(means + stds)``, as the shape models
    call it (a shorter range leaves rows whose min-max normalisation
    divides by a span of a few f32 steps)."""
    if isinstance(case[0], str):
        _, j, a = case
        rng = np.random.default_rng(j)
        means = rng.uniform(40, 150, (j, a))
        stds = rng.uniform(3, 30, (j, a))
        weights = rng.dirichlet(np.ones(j))
        max_dist = np.max(means + stds)
    else:
        means, stds, weights, max_dist = case
    got = tsp.compute_cumulative_distrib(means, stds, weights, max_dist,
                                         device='cpu')
    want = jsp.compute_cumulative_distrib(means, stds, weights, max_dist)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _points(seed, n=3000, span=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    # exact angles on the rows and on the wrap, and the centre itself
    pts[:8] = [[0, 0], [0, 10], [10, 0], [-10, 0], [0, -10], [7, 7],
               [-7, 7], [1e-3, -5]]
    return pts


@pytest.mark.parametrize('shift', [0.0, 90.0, 271.5, 359.0])
def test_shape_prior_points_matches_jax(shift):
    table = _table(0)
    pts = _points(1)
    centre = np.array([3.0, -4.0], np.float32)
    got = tsp.shape_prior_points(torch.as_tensor(pts), table, centre,
                                 shift).numpy()
    want = np.asarray(jsp.shape_prior_points(jnp.asarray(pts), table,
                                             jnp.asarray(centre), shift))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_batched_lookup_equals_single():
    """(O, A, D) tables with (O, 2) centres and (O,) shifts give each
    object's single lookup exactly."""
    tables = np.stack([_table(s) for s in range(3)])
    pts = torch.as_tensor(_points(2))
    centres = np.array([[0, 0], [50, -20], [-80, 100]], np.float32)
    shifts = np.array([0.0, 45.0, 300.0], np.float32)
    got = tsp.shape_prior_points(pts, tables, centres, shifts)
    assert got.shape == (3, len(pts))
    for o in range(3):
        one = tsp.shape_prior_points(pts, tables[o], centres[o],
                                     float(shifts[o]))
        assert torch.equal(got[o], one)


@pytest.mark.parametrize('point,shift,value,tol', [
    ([1, 1], 0, 1.0, 1e-6), ([10, 10], 0, 0.0, 1e-6),
    ([10, -10], 0, 0.1, 1e-3), ([2, 3], 0, 0.806, 1e-2),
    ([-3, -2], 0, 0.381, 1e-2), ([3, -2], 0, 0.676, 1e-2),
    ([2, 3], 270, 0.891, 1e-2)])
def test_shape_prior_table_cdf_doctest(point, shift, value, tol):
    got = tsp.compute_shape_prior_table_cdf(point, CHIST, (1, 1),
                                            angle_shift=shift)
    want = jsp.compute_shape_prior_table_cdf(point, CHIST, (1, 1),
                                             angle_shift=shift)
    assert got == pytest.approx(value, abs=tol)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)


def test_prior_costs_of_all_objects_match_jax():
    """``_eval_prior_costs_all`` (one lookup for every object, -log(p +
    0.01)) against JAX's, with and without a point selection; and the
    one-object ``_eval_prior_costs``."""
    tables = np.stack([_table(s, d=90) for s in range(4)])
    pts = np.round(_points(3, n=800, span=200)).astype(int)
    centres = [[0, 0], [20, 30], [-50, 10], [100, -100]]
    shifts = [0.0, 15.0, 200.0, 359.0]
    sel = np.random.default_rng(4).random(len(pts)) < 0.5
    for mask in (None, sel):
        got = trg._eval_prior_costs_all(pts, tables, centres, shifts, mask,
                                        device='cpu')
        want = jrg._eval_prior_costs_all(pts, tables, centres, shifts, mask)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got = trg._eval_prior_costs(pts, tables[1], centres[1], shifts[1],
                                device='cpu')
    want = jrg._eval_prior_costs(pts, tables[1], centres[1], shifts[1])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
