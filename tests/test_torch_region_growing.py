"""The port's region growing (``region_growing.py``: RG2Sp by GraphCut and
greedy, the shape models, the shape-cost update, the one-shot object
GraphCuts and the host helpers) vs the JAX package on the CPU, at 160x256
on synthetic ovary scenes of three eggs; then the committed 647x1024
fixture that ``chip_smoke.py`` holds the card to.

The shape model is JAX's, fitted on the egg masks of eight training
scenes (24 eggs: fewer eggs than the 15 ray directions leave JAX's f32
mixture fit NaN) and carried across by ``shape_model_from_numpy``.

Bars: host helpers exact (the same float64 numpy); rays exact; the first
round's data and shape LUTs within rtol 1e-5 (the shape costs are f32
lookups); the carried mixture's posteriors within 1e-3 (f32 Cholesky
factors of near-singular 15-D covariances, from 24 rays, in two
libraries); RG2Sp final labels equal on >= 0.99 of the superpixels, each
object's pixel IoU >= 0.98 against JAX's and the iteration count within
+-1 of JAX's; the one-shot object GraphCuts' energy at most 0.5% above
JAX's (their expansion chains draw other noise) and labels >= 0.99
equal, their unaries' probabilities ``exp(-U)`` within 2.5e-7 (far out
in the radial prior XLA's f32 ``erf`` stops at 1 - 1.2e-7 where
``torch.special.erf`` reaches 1, so ``-log(1 - cdf + 1e-9)`` differs
there while the probability differs by two f32 steps).

The shape fits draw their k-means++ seeds from another random source than
JAX's, and on 24 rays in 15 dimensions other seeds reach other optima.
Handed JAX's seeds, each fit is held to JAX's: the component count, the
k-means and spectral partitions and the mixtures' labels ARS >= 0.98, the
mixtures' parameters within rtol 1e-4 (f32 CAVI in two libraries), their
mean log-likelihood within 1e-3 relative, and the survival tables within
rtol 1e-5 plus 1e-6 absolute (the CAVI's 99 f32 iterations leave the
means 1e-5 apart, which moves a table by up to 4e-7).  With the port's
own seeds the component count is JAX's (mean shift is deterministic), the
weights sum to 1 and the mixture's table is JAX's
``compute_cumulative_distrib`` of the port's parameters within the shape
prior's bars (rtol 1e-5 plus 2.5e-7)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import region_growing as jrg
from pyimsegm_tpu.models import gmm as jgmm
from pyimsegm_tpu.ops import graphcut as jgc
from pyimsegm_tpu.ops import shape_prior as jsp
from pyimsegm_tpu.ops.slic import segment_slic_img2d, slic_config
from pyimsegm_tpu.utils.metrics import adjusted_rand_score
from pyimsegm_tpu_torch import region_growing as trg
from pyimsegm_tpu_torch import superpixels as tsp
from pyimsegm_tpu_torch.models import bgm as tbgm
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.ops.slic import slic_config as tslic_config
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
from make_torch_port_fixture import (OUT_RG2SP, OVARY,  # noqa: E402
                                     RG_GRID_SEED, RG_OBJ_SHAPE,
                                     RG_PARAMS, RG_SP, RG_TABLE,
                                     RG_TEST_SEED)

SIZE, N_EGGS, SP = (160, 256), 3, 8
TRAIN_SEEDS, TEST_SEED = (0, 1, 2, 4, 5, 6, 7, 8), 3
LABELS_BAR, IOU_BAR, ITER_SLACK, ENERGY_SLACK = 0.99, 0.98, 1, 0.005
TRUE_SLACK = 0.02
FIT_ARS, FIT_RTOL, FIT_LL_RTOL = 0.98, 1e-4, 1e-3
TABLE_RTOL, TABLE_ATOL, FIT_TABLE_ATOL = 1e-5, 2.5e-7, 1e-6
FITS = ['cdf_mixture', 'sets_mean_cdf_mixture', 'sets_mean_cdf_kmeans',
        'cdf_spectral', 'cdf_kmeans']


@pytest.fixture(scope='module')
def shapes():
    """JAX's rays of the training eggs and its mixture shape model, and
    the model carried into the port."""
    annots = [(sample_ovary_scene(SIZE, N_EGGS, rand_seed=s)[1] > 0)
              .astype(np.int32) for s in TRAIN_SEEDS]
    rays, _ = jrg.compute_object_shapes(annots, ray_step=25, smooth_coef=1,
                                        interp_order='spline')
    model = jrg.transform_rays_model_cdf_mixture(rays)
    carried = trg.shape_model_from_numpy(trg.shape_model_to_numpy(*model),
                                         device='cpu')
    return annots, rays, model, carried


@pytest.fixture(scope='module')
def scene():
    """The test scene, JAX's SLIC of it and the superpixels' foreground
    probabilities."""
    img, segm, centres = sample_ovary_scene(SIZE, N_EGGS,
                                            rand_seed=TEST_SEED)
    slic = np.asarray(segment_slic_img2d(img, sp_size=SP,
                                         relative_compact=0.2))
    prob = jrg.compute_segm_prob_fg(slic, segm, RG_TABLE)
    return img, segm, centres, slic, prob


def _object_ious(got, want, slic, n_obj):
    return [float(((got[slic] == i) & (want[slic] == i)).sum()
                  / max(((got[slic] == i) | (want[slic] == i)).sum(), 1))
            for i in range(1, n_obj + 1)]


def _hold(got, want, slic, n_obj, it_got=None, it_want=None):
    assert (got == want).mean() >= LABELS_BAR
    assert min(_object_ious(got, want, slic, n_obj)) >= IOU_BAR
    if it_want is not None:
        assert abs(it_got - it_want) <= ITER_SLACK


def test_object_shapes_match_jax(shapes):
    annots, rays, _, _ = shapes
    got, shifts = trg.compute_object_shapes(annots, ray_step=25,
                                            smooth_coef=1,
                                            interp_order='spline',
                                            device='cpu')
    np.testing.assert_array_equal(np.asarray(got), np.asarray(rays))
    assert len(shifts) == len(rays) == 24


def test_carried_shape_model(shapes):
    _, rays, (jmodel, jcdfs), (tmodel, tcdfs) = shapes
    np.testing.assert_array_equal(np.asarray(tcdfs), np.asarray(jcdfs))
    np.testing.assert_allclose(tmodel.predict_proba(rays),
                               jmodel.predict_proba(rays), atol=1e-3)
    back = trg.shape_model_to_numpy(tmodel, tcdfs)
    for key, val in trg.shape_model_to_numpy(jmodel, jcdfs).items():
        np.testing.assert_array_equal(back[key], val)


def _n_components(model):
    if hasattr(model, 'weights_'):
        return len(model.weights_)
    return len(model.cluster_centers_)


def _mean_ll(model, rays):
    params = jgmm.GMMParams(*(jnp.asarray(np.asarray(a)) for a in (
        model.weights_, model.means_, model.covariances_)))
    x = jnp.asarray(rays, jnp.float32)
    return float(jgmm.gmm_score(params, x, jnp.ones(len(rays))))


def _fit_labels(model, rays):
    if hasattr(model, 'weights_'):
        return model.predict_proba(rays).argmax(axis=1)
    return np.asarray(model.labels_)


@pytest.mark.parametrize('name', FITS + ['cdf_histograms'])
def test_shape_model_fits(shapes, name):
    """The port's own fits (its own k-means++ seeds): JAX's component
    count, finite non-increasing survival tables of JAX's shape, weights
    summing to 1 and the mixture's table built from its parameters as JAX
    builds it (the histogram tables, plain numpy, equal); the set models
    round-trip through their arrays."""
    rays = np.asarray(shapes[1], float)
    tfn = getattr(trg, 'transform_rays_model_' + name)
    jfn = getattr(jrg, 'transform_rays_model_' + name)
    if name == 'cdf_histograms':
        assert tfn(rays) == jfn(rays)
        return
    model, tables = tfn(rays, device='cpu')
    jmodel, jtables = jfn(rays)
    assert _n_components(model) == _n_components(jmodel)
    if hasattr(model, 'weights_'):
        assert float(np.sum(model.weights_)) == pytest.approx(1.0, rel=1e-6)
    if name.startswith('sets'):
        assert len(tables) == len(jtables)
        for (mean, cdf), (jmean, jcdf) in zip(tables, jtables):
            assert len(mean) == len(jmean) == 15
            assert cdf.shape[0] == jcdf.shape[0] and np.isfinite(cdf).all()
        again = trg.shape_model_from_numpy(
            trg.shape_model_to_numpy(model, tables), device='cpu')[1]
        for (m1, c1), (m2, c2) in zip(tables, again):
            np.testing.assert_array_equal(c1, c2)
        return
    tables = np.asarray(tables)
    assert tables.shape[0] == np.asarray(jtables).shape[0] == 15
    assert np.isfinite(tables).all() and tables.min() >= 0
    assert np.all(np.diff(tables, axis=1) <= 1e-6)
    assert model.predict_proba(rays[:3]).shape[0] == 3
    if name == 'cdf_mixture':
        stds = np.sqrt(np.abs(np.diagonal(model.covariances_, axis1=1,
                                          axis2=2)))
        want = jsp.compute_cumulative_distrib(
            model.means_, stds, model.weights_,
            np.max(model.means_ + stds))
        np.testing.assert_allclose(tables, np.asarray(want),
                                   rtol=TABLE_RTOL, atol=TABLE_ATOL)


def _jax_seeding(generator, x, sample_weight, n_clusters, batch=None):
    """The k-means++ seeds JAX's fits draw on the same points: from
    ``PRNGKey(0)`` for one k-means, from its ``batch`` splits for the
    restarts of a mixture."""
    xj = jnp.asarray(x.cpu().numpy())
    wj = jnp.asarray(sample_weight.cpu().numpy())
    keys = [jax.random.PRNGKey(0)] if batch is None \
        else jax.random.split(jax.random.PRNGKey(0), batch)
    seeds = np.stack([np.asarray(jgmm.kmeans_plus_plus_init(k, xj, wj,
                                                            n_clusters))
                      for k in keys])
    return torch.as_tensor(seeds[0] if batch is None else seeds,
                           device=x.device)


@pytest.mark.parametrize('name', FITS)
def test_shape_model_fits_from_jax_seeds(shapes, name, monkeypatch):
    """Each fit handed JAX's k-means++ seeds, against JAX's fit: the
    component count, the partition, the mixture's parameters and
    likelihood, and the survival table or tables."""
    monkeypatch.setattr(tgmm, 'kmeans_plus_plus_init', _jax_seeding)
    monkeypatch.setattr(tbgm, 'kmeans_plus_plus_init', _jax_seeding)
    rays = np.asarray(shapes[1], float)
    model, tables = getattr(trg, 'transform_rays_model_' + name)(
        rays, device='cpu')
    jmodel, jtables = getattr(jrg, 'transform_rays_model_' + name)(rays)
    assert _n_components(model) == _n_components(jmodel)
    assert adjusted_rand_score(_fit_labels(model, rays),
                               _fit_labels(jmodel, rays)) >= FIT_ARS
    if hasattr(model, 'weights_'):
        for got, want in ((model.weights_, jmodel.weights_),
                          (model.means_, jmodel.means_),
                          (model.covariances_, jmodel.covariances_)):
            np.testing.assert_allclose(got, want, rtol=FIT_RTOL,
                                       atol=FIT_RTOL)
        assert _mean_ll(model, rays) == pytest.approx(
            _mean_ll(jmodel, rays), rel=FIT_LL_RTOL)
    else:
        np.testing.assert_allclose(model.cluster_centers_,
                                   jmodel.cluster_centers_, rtol=FIT_RTOL,
                                   atol=FIT_RTOL)
    if name.startswith('sets'):
        assert len(tables) == len(jtables)
        pairs = [(np.asarray(m), np.asarray(c), np.asarray(jm),
                  np.asarray(jc))
                 for (m, c), (jm, jc) in zip(tables, jtables)]
    else:
        pairs = [(None, np.asarray(tables), None, np.asarray(jtables))]
    for mean, cdf, jmean, jcdf in pairs:
        if mean is not None:
            np.testing.assert_allclose(mean, jmean, rtol=TABLE_RTOL)
        assert cdf.shape == jcdf.shape
        np.testing.assert_allclose(cdf, jcdf, rtol=TABLE_RTOL,
                                   atol=FIT_TABLE_ATOL)


def test_host_helpers_match_jax(scene):
    img, segm, centres, slic, prob = scene
    np.testing.assert_array_equal(
        trg.compute_segm_prob_fg(slic, segm, RG_TABLE), prob)
    k = int(slic.max()) + 1
    jk, je, jv, jc, jw = jrg._graph_setup(slic)
    tk, te, tv, tc, tw = trg._graph_setup(slic, device='cpu')
    assert tk == jk
    for a, b in ((te, je), (tv, jv), (tc, jc), (tw, jw)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, k)
    for allow in (True, False):
        np.testing.assert_array_equal(
            trg._candidate_masks(te, tv, labels, 3, allow),
            jrg._candidate_masks(je, jv, labels, 3, allow))
    np.testing.assert_array_equal(trg._neighbor_class_mask(te, tv, labels, 4),
                                  jrg._neighbor_class_mask(je, jv, labels, 4))
    neigh = trg.get_neighboring_segments(te[tv])
    assert neigh == jrg.get_neighboring_segments(je[jv])
    assert tsp.get_neighboring_segments(te[tv]) == neigh
    for obj in (1, 2):
        for other in (True, False):
            assert trg.get_neighboring_candidates(neigh, labels, obj, other) \
                == jrg.get_neighboring_candidates(neigh, labels, obj, other)
    centres_r = np.round(centres).astype(int)
    lut_t, lab_t = trg.compute_data_costs_points(slic, prob, centres_r,
                                                 np.zeros(k, int))
    lut_j, lab_j = jrg.compute_data_costs_points(slic, prob, centres_r,
                                                 np.zeros(k, int))
    np.testing.assert_array_equal(lut_t, lut_j)
    np.testing.assert_array_equal(lab_t, lab_j)
    np.testing.assert_array_equal(
        trg.enforce_center_labels(slic, labels.copy(), centres),
        jrg.enforce_center_labels(slic, labels.copy(), centres))
    lut_s = rng.random((k, 4))
    w = np.bincount(slic.ravel())
    ev = te[tv]
    args = (labels, lut_t, lut_s, w, ev, 1.0, 5.0, 15.0, [0.1, 0.03])
    assert trg.compute_rg_crit(*args) == jrg.compute_rg_crit(*args)
    dev = trg.compute_rg_crit(*(torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args))
    assert float(dev) == pytest.approx(jrg.compute_rg_crit(*args), rel=1e-12)
    np.testing.assert_array_equal(
        trg.compute_pairwise_penalty(ev, labels, 0.1, 0.03),
        jrg.compute_pairwise_penalty(ev, labels, 0.1, 0.03))
    pts = rng.random((30, 2)) * 50
    for got, want in zip(trg.compute_centre_moment_points(pts),
                         jrg.compute_centre_moment_points(pts)):
        np.testing.assert_array_equal(got, want)
    cand = np.nonzero(trg._candidate_masks(te, tv, labels, 3, True)
                      .any(axis=1))[0][:20]
    points = np.round(tc).astype(int)
    for got, want in zip(
            trg.prepare_graphcut_variables(cand, points, neigh, w, labels, 3,
                                           lut_t, lut_s, 1., 5., 15.,
                                           [0.1, 0.03]),
            jrg.prepare_graphcut_variables(cand, points, neigh, w, labels, 3,
                                           lut_t, lut_s, 1., 5., 15.,
                                           [0.1, 0.03])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert trg._infer_grid_cfg(slic) == tuple(jrg._infer_grid_cfg(slic))
    assert trg._infer_grid_cfg(_scrambled(slic)) is None


def _scrambled(slic):
    """The same partition under permuted ids: not a grid map, so RG2Sp
    takes the edge-list solver."""
    perm = np.random.default_rng(1).permutation(int(slic.max()) + 1)
    return perm[slic]


@pytest.mark.parametrize('shape_type', ['cdf', 'set_cdfs'])
def test_update_shape_costs_match_jax(shapes, scene, shape_type):
    """The numpy API of the shape update, a round after the first (moved
    centres, a swapped axis)."""
    _, rays, model, _ = shapes
    if shape_type == 'set_cdfs':
        model = jrg.transform_rays_model_sets_mean_cdf_mixture(rays, 2)
        carried = trg.shape_model_from_numpy(
            trg.shape_model_to_numpy(*model), device='cpu')
    else:
        carried = trg.shape_model_from_numpy(
            trg.shape_model_to_numpy(*model), device='cpu')
    _, segm, centres, slic, prob = scene
    k = int(slic.max()) + 1
    pts = np.round(jrg._graph_setup(slic)[3]).astype(int)
    labels = np.asarray(prob > 0.5, int) * (1 + (pts[:, 1] > SIZE[1] // 2))
    init = np.round(centres[:2]).astype(int)
    outs = []
    for rg, mdl, kw in ((jrg, model, {}), (trg, carried, {'device': 'cpu'})):
        lut = np.zeros((k, 3))
        state = rg.update_shape_costs_points(
            lut, slic, pts, labels, init, np.full((2, 2), np.inf),
            np.zeros(2), [1, 1], mdl, shape_type, **kw)
        outs.append(rg.update_shape_costs_points(
            state[0], slic, pts, labels, init, state[1] + 40, state[2],
            state[3], mdl, shape_type, swap_shift=True, **kw))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    for got, want in zip(outs[1][1:], outs[0][1:]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _rg(pkg, fn, slic, prob, centres, model, **kw):
    hist = {}
    mod = trg if pkg == 'torch' else jrg
    if pkg == 'torch':
        kw['device'] = 'cpu'
    labels = getattr(mod, fn)(slic, prob, centres, model, 'cdf',
                              debug_history=hist, **kw)
    return labels, hist


@pytest.mark.parametrize('route', ['grid', 'edge_list', 'per_object'])
def test_graphcut_rg2sp_matches_jax(shapes, scene, route):
    """GraphCut RG2Sp on JAX's SLIC with the carried model: the grid solve
    (``grid_cfg``), the edge-list ``solve_mrf`` of a non-grid map (the same
    partition, ids permuted) and ``optim_global=False``."""
    _, _, jmodel, tmodel = shapes
    _, _, centres, slic, prob = scene
    kw = dict(RG_PARAMS, nb_iter=30)
    if route == 'grid':
        jkw, tkw = dict(grid_cfg=slic_config(*SIZE, SP)), \
            dict(grid_cfg=tslic_config(*SIZE, SP))
    else:
        jkw, tkw = {}, {}
    if route == 'edge_list':
        perm = np.random.default_rng(1).permutation(int(slic.max()) + 1)
        slic, prob = perm[slic], prob[np.argsort(perm)]
    if route == 'per_object':
        kw.update(optim_global=False, nb_iter=8)
    want, jh = _rg('jax', 'region_growing_shape_slic_graphcut', slic, prob,
                   centres, jmodel, **kw, **jkw)
    got, th = _rg('torch', 'region_growing_shape_slic_graphcut', slic, prob,
                  centres, tmodel, **kw, **tkw)
    np.testing.assert_array_equal(th['lut_data_cost'], jh['lut_data_cost'])
    np.testing.assert_allclose(th['lut_shape_cost'][0],
                               jh['lut_shape_cost'][0], rtol=1e-5)
    assert th['criteria'][0] == pytest.approx(jh['criteria'][0], rel=1e-5)
    _hold(got, want, slic, len(centres), len(th['labels']),
          len(jh['labels']))


def test_greedy_rg2sp_matches_jax(shapes, scene):
    _, _, jmodel, tmodel = shapes
    _, _, centres, slic, prob = scene
    want, jh = _rg('jax', 'region_growing_shape_slic_greedy', slic, prob,
                   centres, jmodel, **RG_PARAMS)
    got, th = _rg('torch', 'region_growing_shape_slic_greedy', slic, prob,
                  centres, tmodel, **RG_PARAMS)
    np.testing.assert_allclose(th['lut_shape_cost'][0],
                               jh['lut_shape_cost'][0], rtol=1e-5)
    _hold(got, want, slic, len(centres), len(th['labels']),
          len(jh['labels']))


def _energy(labels, unary, edges, weights, pairwise):
    return float(jgc.mrf_energy(
        jnp.asarray(labels), jnp.asarray(unary, jnp.float32),
        jnp.asarray(edges), jnp.asarray(weights, jnp.float32),
        jnp.asarray(pairwise, jnp.float32)))


def test_object_segmentation_graphcut_slic(scene):
    _, segm, centres, slic, _ = scene
    kw = dict(labels_fg_prob=RG_TABLE, **RG_OBJ_SHAPE)
    jdv, tdv = {}, {}
    want = jrg.object_segmentation_graphcut_slic(slic, segm, centres,
                                                 debug_visual=jdv, **kw)
    got = trg.object_segmentation_graphcut_slic(slic, segm, centres,
                                                debug_visual=tdv,
                                                device='cpu', **kw)
    for a, b in zip(tdv['unary_imgs'], jdv['unary_imgs']):
        np.testing.assert_allclose(np.exp(-a), np.exp(-b), rtol=0,
                                   atol=2.5e-7)
    assert (got == want).mean() >= LABELS_BAR
    zero = trg.object_segmentation_graphcut_slic(
        slic, segm, centres, labels_fg_prob=RG_TABLE, gc_regul=0,
        device='cpu')
    np.testing.assert_array_equal(zero, jrg.object_segmentation_graphcut_slic(
        slic, segm, centres, labels_fg_prob=RG_TABLE, gc_regul=0))
    with pytest.raises(ValueError):
        trg.object_segmentation_graphcut_slic(slic, segm, centres,
                                              device='cpu')


def test_object_segmentation_graphcut_pixels(scene):
    """The pixel graph (40,960 nodes, ~81,500 edges) of the scene's
    segmentation: energy within the chains' slack of JAX's."""
    _, segm, centres, _, _ = scene
    jdv, tdv = {}, {}
    want = jrg.object_segmentation_graphcut_pixels(
        segm, centres, labels_fg_prob=RG_TABLE, debug_visual=jdv)
    got = trg.object_segmentation_graphcut_pixels(
        segm, centres, labels_fg_prob=RG_TABLE, debug_visual=tdv,
        device='cpu')
    for a, b in zip(tdv['unary_imgs'], jdv['unary_imgs']):
        np.testing.assert_array_equal(a, b)
    c = len(centres) + 1
    unary = np.stack(jdv['unary_imgs'], -1).reshape(-1, c)
    edges = jrg._grid_edges(*SIZE)
    args = (unary, edges, np.ones(len(edges)), 1 - np.eye(c))
    assert _energy(got.reshape(-1), *args) <= \
        _energy(want.reshape(-1), *args) * (1 + ENERGY_SLACK)
    assert (got == want).mean() >= LABELS_BAR
    seeded = trg.object_segmentation_graphcut_pixels(
        segm, centres, labels_fg_prob=RG_TABLE, seed_size=3, gc_regul=0,
        device='cpu')
    np.testing.assert_array_equal(
        seeded, jrg.object_segmentation_graphcut_pixels(
            segm, centres, labels_fg_prob=RG_TABLE, seed_size=3,
            gc_regul=0))


@pytest.fixture(scope='module')
def fixture():
    with np.load(OUT_RG2SP) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize('solver', ['gc', 'grid', 'greedy'])
def test_fixture_rg2sp(fixture, solver):
    """Config 5 at 647x1024 on the fixture's SLIC with the carried model,
    as ``chip_smoke.py`` runs it on the card: GraphCut RG2Sp on the test
    scene (K = 3,034: the edge-list solve) and on the second scene (K =
    3,036: the grid solve), and greedy RG2Sp."""
    seed = RG_GRID_SEED if solver == 'grid' else RG_TEST_SEED
    _, segm, centres = sample_ovary_scene(OVARY, 4, rand_seed=seed)
    slic = fixture['grid_slic' if solver == 'grid' else 'slic'] \
        .astype(np.int32)
    prob = trg.compute_segm_prob_fg(slic, segm, RG_TABLE)
    if solver != 'grid':
        np.testing.assert_array_equal(centres, fixture['centres'])
        np.testing.assert_array_equal(prob, fixture['prob_fg'])
    model = trg.shape_model_from_numpy(
        {k[6:]: v for k, v in fixture.items() if k.startswith('shape_')},
        device='cpu')
    kw = dict(RG_PARAMS)
    if solver == 'greedy':
        fn = 'region_growing_shape_slic_greedy'
    else:
        kw['grid_cfg'] = tslic_config(*OVARY, RG_SP)
        fn = 'region_growing_shape_slic_graphcut'
    if solver != 'greedy':
        k = int(slic.max()) + 1
        assert (k == kw['grid_cfg'].n_segments) == (solver == 'grid')
    got, hist = _rg('torch', fn, slic, prob, centres, model, **kw)
    key = 'gc' if solver == 'gc' else solver
    _hold(got, fixture['%s_labels' % key], slic, len(centres),
          len(hist['labels']), int(fixture['%s_iters' % key]))
    np.testing.assert_allclose(hist['criteria'][0],
                               fixture['%s_criteria' % key][0], rtol=1e-5)


@pytest.mark.parametrize('solver', ['gc', 'greedy'])
def test_fixture_rg2sp_on_port_slic(fixture, solver):
    """Config 5 on the port's own SLIC of the test scene, as the card's
    chain runs it: the port against JAX on that same SLIC (the labels and
    iteration bars), and each egg's IoU with the true egg no worse than
    JAX's on its own SLIC by more than TRUE_SLACK.  The greedy stops at
    its round cap with eggs part grown, so the few superpixels in which
    the two SLICs differ move its objects for JAX too: they are held to
    the true eggs across the SLICs, not to JAX's objects."""
    from scipy import ndimage
    img, segm, centres = sample_ovary_scene(OVARY, 4, rand_seed=RG_TEST_SEED)
    slic = np.asarray(tsp.segment_slic_img2d(img, sp_size=RG_SP,
                                             relative_compact=0.2,
                                             device='cpu'))
    prob = trg.compute_segm_prob_fg(slic, segm, RG_TABLE)
    arrays = {k[6:]: v for k, v in fixture.items() if k.startswith('shape_')}
    tmodel = trg.shape_model_from_numpy(arrays, device='cpu')
    jmodel = (jrg.GMMShapeModel(jgmm.GMMParams(*(
        jnp.asarray(arrays[k]) for k in ('weights', 'means', 'covs')))),
              arrays['cdf'].tolist())
    kw = dict(RG_PARAMS)
    fn = 'region_growing_shape_slic_greedy'
    if solver == 'gc':
        fn = 'region_growing_shape_slic_graphcut'
        jkw, tkw = dict(grid_cfg=slic_config(*OVARY, RG_SP)), \
            dict(grid_cfg=tslic_config(*OVARY, RG_SP))
    else:
        jkw, tkw = {}, {}
    want, jh = _rg('jax', fn, slic, prob, centres, jmodel, **kw, **jkw)
    got, th = _rg('torch', fn, slic, prob, centres, tmodel, **kw, **tkw)
    _hold(got, want, slic, len(centres), len(th['labels']),
          len(jh['labels']))
    comp, _ = ndimage.label(segm > 0)
    eggs = [comp == comp[int(round(c[0])), int(round(c[1]))]
            for c in centres]
    key = 'gc' if solver == 'gc' else 'greedy'
    want_true = _object_masks_ious(fixture['%s_labels' % key],
                                   fixture['slic'], eggs)
    for got_iou, want_iou in zip(_object_masks_ious(got, slic, eggs),
                                 want_true):
        assert got_iou >= want_iou - TRUE_SLACK


def _object_masks_ious(labels, slic, masks):
    obj = np.asarray(labels)[slic]
    return [float(((obj == i + 1) & m).sum() / max(((obj == i + 1) | m).sum(),
                                                   1))
            for i, m in enumerate(masks)]
