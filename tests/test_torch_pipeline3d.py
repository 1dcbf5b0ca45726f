"""The port's 3D gray-volume path against the JAX package on the CPU: the
supervoxel adjacency and edge weights, the 125-channel MRF weights and
solve, the gray features, and the whole
``pipe_gray3d_slic_features_model_graphcut`` against the JAX result stored
in ``tests/data/torch_port_fixture_3d.npz`` (the JAX core takes minutes to
compile, so it is not run live here)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import descriptors as jdesc
from pyimsegm_tpu.ops import graph as jgraph
from pyimsegm_tpu.ops import graphcut as jgc
from pyimsegm_tpu.ops import slic3d as jslic3d
from pyimsegm_tpu_torch import descriptors as tdesc
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.models.class_model import (class_model_from_numpy,
                                                   estim_class_model)
from pyimsegm_tpu_torch.ops import graph as tgraph
from pyimsegm_tpu_torch.ops import graphcut as tgc
from pyimsegm_tpu_torch.ops import slic3d as tslic3d
from pyimsegm_tpu_torch.ops.slic import compactness_from_regul
from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
from pyimsegm_tpu_torch.utils.metrics import (adjusted_rand_score,
                                              segment_digest)

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_3D = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_3d.npz')
FIXTURE_3D_TLM = os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture_3d_tlm.npz')
FEATURES = {'color': ['mean', 'std', 'energy']}
FEATURES_TLM = {'color': ['mean', 'std', 'energy'], 'tLM': ['mean']}
FLAGS_ALL = ['mean', 'std', 'energy', 'median', 'meanGrad']


def _slic(shape, seed, sp=8, spacing=(2, 1, 1)):
    """Structured volume, its supervoxel labels (port twin) and both
    configs."""
    vol = sample_gray_volume_3d(shape, rand_seed=seed)[0]
    ct = tslic3d.slic3d_config(shape, sp, spacing)
    cj = jslic3d.slic3d_config(shape, sp, spacing)
    lab = tslic3d.slic3d_segment(torch.as_tensor(vol), ct,
                                 compactness_from_regul(sp, 0.2))
    return vol, lab.numpy(), cj, ct


def _far_labels(shape=(16, 40, 48)):
    """Every voxel labelled with its own tile's cell, except on both sides
    of one tile boundary per axis, where the voxels take the cells one
    further out: adjacent voxels whose labels lie 3 cells apart."""
    ct = tslic3d.slic3d_config(shape, 8, (2, 1, 1))
    cj = jslic3d.slic3d_config(shape, 8, (2, 1, 1))
    (sz, sy, sx), (_, gy, gx) = ct.steps, ct.grid
    tz, ty, tx = np.meshgrid(*[np.arange(n) // s for n, s in
                               zip(shape, ct.steps)], indexing='ij')
    lab = (tz * gy + ty) * gx + tx
    for axis, (step, stride) in enumerate(((sz, gy * gx), (sy, gx),
                                           (sx, 1))):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], hi[axis] = 2 * step - 1, 2 * step
        lab[tuple(lo)] -= stride
        lab[tuple(hi)] += stride
    return lab.astype(np.int32), cj, ct


def _labels_case(case):
    if case == 'far':
        return _far_labels()
    _vol, lab, cj, ct = _slic((8, 40, 48), 0)
    return lab, cj, ct


@pytest.mark.parametrize('case', ['slic', 'far'])
def test_adjacency_edges_match_jax(case):
    """The presence-table edge list equals the pair-hash unique: exact,
    padding included, also with pairs 3 cells apart."""
    lab, cj, ct = _labels_case(case)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(lab), cj.n_segments)
    et, vt = tgraph.adjacency_edges_3d(torch.as_tensor(lab), ct.n_segments,
                                       ct)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    counts = tgraph.adjacency3d_counts(torch.as_tensor(lab), ct)
    assert counts['edges'] == int(np.asarray(vj).sum())
    assert counts['capacity'] == 8 * ct.n_segments
    assert (counts['far_edges'] > 0) == (case == 'far')


def test_adjacency_edges_truncate_like_jax():
    """Beyond the 8K capacity the smallest codes are kept, as
    ``jnp.unique(size=8K)`` keeps them: labels of a 3x3x3 grid scattered
    over the volume make more distinct pairs than 8 * 27."""
    rng = np.random.default_rng(3)
    shape = (9, 9, 9)
    ct = tslic3d.slic3d_config(shape, 3, (1, 1, 1))
    cj = jslic3d.slic3d_config(shape, 3, (1, 1, 1))
    lab = rng.integers(0, ct.n_segments, shape).astype(np.int32)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(lab), cj.n_segments)
    et, vt = tgraph.adjacency_edges_3d(torch.as_tensor(lab), ct.n_segments,
                                       ct)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert tgraph.adjacency3d_counts(torch.as_tensor(lab), ct)['edges'] \
        > 8 * ct.n_segments


@pytest.mark.parametrize('case', ['slic', 'far'])
def test_wgrid3d_from_edges_matches_jax(case):
    """The 125-channel fold, aliasing and dropping as the reference's
    scatter does (rtol 1e-5)."""
    lab, cj, ct = _labels_case(case)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(lab), cj.n_segments)
    w = np.random.default_rng(1).random(len(vj)).astype(np.float32)
    want = np.asarray(jslic3d.wgrid3d_from_edges(ej, vj, jnp.asarray(w), cj))
    got = tslic3d.wgrid3d_from_edges(torch.as_tensor(np.asarray(ej)),
                                     torch.as_tensor(np.asarray(vj)),
                                     torch.as_tensor(w), ct).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('edge_type', ['', 'spatial', 'model', 'model_l1',
                                       'model_l2', 'features', 'color'])
def test_compute_edge_weights_match_jax(edge_type):
    vol, lab, cj, ct = _slic((8, 40, 48), 2)
    k = ct.n_segments
    rng = np.random.default_rng(4)
    proba = rng.random((k, 2)).astype(np.float32)
    proba /= proba.sum(-1, keepdims=True)
    feats = rng.normal(size=(k, 3)).astype(np.float32)
    image = np.stack([vol, vol[::-1]], axis=-1) * 255.0
    ej, wj, vj = jgc.compute_edge_weights(
        jnp.asarray(lab), k, image=jnp.asarray(image),
        features=jnp.asarray(feats), proba=jnp.asarray(proba),
        edge_type=edge_type)
    et, wt, vt = tgc.compute_edge_weights(
        torch.as_tensor(lab), k, image=torch.as_tensor(image),
        features=torch.as_tensor(feats), proba=torch.as_tensor(proba),
        edge_type=edge_type, grid_cfg3d=ct)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-7)


def test_edge_lists_of_2d_or_non_grid_labels_raise():
    """Edge lists of 2D labels and of 3D labels without their grid (which
    raised until the edge-list MRF was ported) equal JAX's, and the
    generic MRF stage solves them: a single-label map gives class 0
    (the lower unary), a non-grid volume JAX's labels by energy."""
    lab = torch.zeros((8, 8), dtype=torch.int32)
    edges, weights, valid = tgc.compute_edge_weights(lab, 1)
    assert not bool(valid.any()) and float(weights.sum()) == 0.0
    out = tgc.segment_graph_cut_general(
        lab, torch.tensor([[0.6, 0.4]]), 1, gc_regul=1.0)
    assert out.tolist() == [0]
    _vol, lab3, _cj, _ct = _slic((8, 32, 48), 6)
    k = int(lab3.max()) + 1
    perm = np.random.default_rng(3).permutation(k)
    lab3 = perm[lab3].astype(np.int32)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(lab3), k)
    et, wt, vt = tgc.compute_edge_weights(torch.as_tensor(lab3), k)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    proba = np.random.default_rng(4).dirichlet(np.ones(2), k) \
        .astype(np.float32)
    want = np.asarray(jgc.segment_graph_cut_general(
        jnp.asarray(lab3), jnp.asarray(proba), k, gc_regul=1.0,
        edge_type='model'))
    got = tgc.segment_graph_cut_general(
        torch.as_tensor(lab3), torch.as_tensor(proba), k, gc_regul=1.0,
        edge_type='model').numpy()
    _, wj, _ = jgc.compute_edge_weights(jnp.asarray(lab3), k,
                                        proba=jnp.asarray(proba),
                                        edge_type='model')
    unary = jgc.compute_unary_cost(jnp.asarray(proba))
    pw = jnp.asarray(jgc.compute_pairwise_cost(1.0, 2), jnp.float32)

    def energy(labels):
        return float(jgc.mrf_energy(jnp.asarray(labels), unary, ej, wj, pw))
    assert energy(got) <= energy(want) * 1.005


def test_solve_mrf_grid3d_matches_jax():
    """Same unary and 125-channel weights: labels >= 0.999 equal (the
    messages are summed in another order), and the energy of the port's
    labelling equals the JAX energy of it."""
    _vol, lab, cj, ct = _slic((16, 64, 96), 5)
    k = ct.n_segments
    rng = np.random.default_rng(6)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(lab), k)
    w = jnp.where(vj, rng.random(len(vj)).astype(np.float32), 0.0)
    wgrid = jslic3d.wgrid3d_from_edges(ej, vj, w, cj)
    unary = rng.random((k, 3)).astype(np.float32) * 3.0
    pw = np.asarray(jgc.compute_pairwise_cost(0.5, 3), np.float32)
    want = np.asarray(jslic3d.solve_mrf_grid3d(jnp.asarray(unary), wgrid,
                                               jnp.asarray(pw), cj))
    got = tslic3d.solve_mrf_grid3d(torch.as_tensor(unary),
                                   torch.as_tensor(np.asarray(wgrid)),
                                   torch.as_tensor(pw), ct)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).mean() >= 0.999
    lab_g = got.numpy().reshape(ct.grid)
    ug = unary.reshape(ct.grid + (3,))
    ej_ = jslic3d.grid3d_mrf_energy(jnp.asarray(lab_g), jnp.asarray(ug),
                                    wgrid, jnp.asarray(pw))
    et_ = tslic3d.grid3d_mrf_energy(torch.as_tensor(lab_g),
                                    torch.as_tensor(ug),
                                    torch.as_tensor(np.asarray(wgrid)),
                                    torch.as_tensor(pw))
    np.testing.assert_allclose(float(et_), float(ej_), rtol=1e-5)


@pytest.mark.parametrize('grid', [True, False], ids=['grid', 'segment_sum'])
def test_gray3d_features_match_jax(grid):
    vol, lab, cj, ct = _slic((8, 40, 48), 7)
    k = ct.n_segments
    spec = {'color': FLAGS_ALL[:3], 'color_hsv': FLAGS_ALL[3:]}
    fj, nj = jdesc.compute_selected_features_gray3d(
        jnp.asarray(vol), jnp.asarray(lab.ravel()), k, spec,
        grid_ctx3d=(jnp.asarray(lab), cj) if grid else None)
    ft, nt = tdesc.compute_selected_features_gray3d(
        torch.as_tensor(vol), torch.as_tensor(lab.ravel()), k, spec,
        grid_ctx3d=(torch.as_tensor(lab), ct) if grid else None)
    assert nt == nj == ['gray_%s' % f for f in FLAGS_ALL]
    # atol 1e-5: std = sqrt(E[v^2] - E[v]^2) cancels, which turns the other
    # summation order of the grid sums into ~6e-6 absolute
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-5)


def test_gray2d_features_without_grid_match_jax():
    vol, lab, _cj, ct = _slic((8, 40, 48), 8)
    img, seg = vol[3], lab[3]
    k = ct.n_segments
    fj, nj = jdesc.compute_selected_features_gray2d(
        jnp.asarray(img), jnp.asarray(seg.ravel()), k, {'color': FLAGS_ALL})
    ft, nt = tdesc.compute_selected_features_gray2d(
        torch.as_tensor(img), torch.as_tensor(seg.ravel()), k,
        {'color': FLAGS_ALL})
    assert nt == nj
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-6)
    # LM texture alone on a volume (formerly a raise): JAX's names, values
    # within rtol 1e-5 + 1e-4
    fj, nj = jdesc.compute_selected_features_gray3d(
        jnp.asarray(vol), jnp.asarray(lab.ravel()), k, {'tLM': ['mean']})
    ft, nt = tdesc.compute_selected_features_gray3d(
        torch.as_tensor(vol), torch.as_tensor(lab.ravel()), k,
        {'tLM': ['mean']})
    assert nt == nj
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('grid', [True, False], ids=['grid', 'segment_sum'])
@pytest.mark.parametrize('key', ['tLM', 'tLM_short'])
def test_gray3d_texture_features_match_jax(grid, key):
    """Colour and LM texture statistics of a volume (every flag, in an
    order that is not canonical): names equal, values within rtol 1e-5 +
    1e-4; the feature names without compute equal too."""
    vol, lab, cj, ct = _slic((4, 40, 48), 9)
    k = ct.n_segments
    spec = {'color': ['mean'], key: ['energy', 'mean', 'median', 'std',
                                     'meanGrad']}
    fj, nj = jdesc.compute_selected_features_gray3d(
        jnp.asarray(vol), jnp.asarray(lab.ravel()), k, spec,
        grid_ctx3d=(jnp.asarray(lab), cj) if grid else None)
    ft, nt = tdesc.compute_selected_features_gray3d(
        torch.as_tensor(vol), torch.as_tensor(lab.ravel()), k, spec,
        grid_ctx3d=(torch.as_tensor(lab), ct) if grid else None)
    assert nt == nj == tdesc.feature_names(spec, gray3d=True) == \
        jdesc.feature_names(spec, gray3d=True)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-4)


def test_pipe_gray3d_tlm_matches_stored_jax_result():
    """The 3D pipe with LM texture on the CPU at the size of
    ``tests/data/torch_port_fixture_3d_tlm.npz`` (8x160x192, the 3D
    workload's sp_size and spacing): SLIC labels of the stored slices >=
    0.999 equal, the standardised features of the supervoxels whose voxel
    sets JAX's labelling has within atol 1e-2 (standardising divides the
    ~1e-5 differences of a column by its spread over the supervoxels), the
    port's GMM fit of the stored JAX features within 1e-3 relative of the
    JAX fit's weighted mean log-likelihood, and segmentation ARS >= 0.98.
    (With tLM's five flags, 63 features of 286 supervoxels, JAX's own GMM
    fit at this size returns NaN, so the file holds tLM's mean.)"""
    with np.load(FIXTURE_3D_TLM) as npz:
        fx = {k: npz[k] for k in npz.files}
    shape = tuple(int(s) for s in fx['shape'])
    vol = sample_gray_volume_3d(shape)[0]
    debug = {}
    segm = tpipe.pipe_gray3d_slic_features_model_graphcut(
        vol, 2, FEATURES_TLM, spacing=(4, 1, 1), sp_size=15, sp_regul=0.2,
        gc_regul=0.1, device='cpu', debug_visual=debug)
    assert segm.shape == shape and segm.dtype == np.int64
    want = np.unpackbits(fx['segm_bits'])[:segm.size].reshape(shape)
    ars = adjusted_rand_score(segm, want)
    assert (debug['slic'][fx['slices']] == fx['slic']).mean() >= 0.999
    same = np.all(segment_digest(debug['slic'], fx['features'].shape[0])
                  == fx['digest'], axis=1)
    got = debug['features']
    print('3D tLM pipe: %d features, ARS %.6f, %d of %d supervoxels with '
          "JAX's voxel sets, their features max diff %.3g"
          % (got.shape[1], ars, same.sum(), same.size,
             np.abs(got - fx['features'])[same].max()))
    assert got.shape == fx['features'].shape
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[same], fx['features'][same], atol=1e-2)
    x, w = torch.as_tensor(fx['features']), torch.as_tensor(fx['mask'])
    jm = class_model_from_numpy({k: fx[k] for k in (
        'weights', 'means', 'covs', 'scaler_mean', 'scaler_scale')})
    tm = estim_class_model(x, 2, 'GMM', sample_weight=w, seed=0)
    ll_j = float(tgmm.gmm_score(jm.gmm, jm.transform(x), w))
    ll_t = float(tgmm.gmm_score(tm.gmm, tm.transform(x), w))
    assert abs(ll_t - ll_j) <= 1e-3 * abs(ll_j)
    assert ars >= 0.98


def _fixture(prefix):
    with np.load(FIXTURE_3D) as npz:
        return {k[len(prefix):]: npz[k] for k in npz.files
                if k.startswith(prefix)}


def test_pipe_gray3d_matches_stored_jax_result():
    """The whole pipe on the CPU at the small size of the fixture: SLIC
    labels >= 0.999 equal on the stored slices, features as stated below,
    segmentation ARS >= 0.98.  The GMM is held by the fit path's bar on the
    same features: the port's fit of the stored JAX features scores within 1e-3
    relative of the JAX fit's weighted mean log-likelihood (the two fits
    draw other random restarts).  With K = 60 supervoxels the EM's
    stopping tolerance is itself ~1e-3 of that likelihood, so a fit on the
    port's own features (which differ as stated) may settle ~1e-3 away."""
    fx = _fixture('small_')
    shape = tuple(int(s) for s in fx['shape'])
    vol = sample_gray_volume_3d(shape)[0]
    debug = {}
    segm = tpipe.pipe_gray3d_slic_features_model_graphcut(
        vol, 2, FEATURES, spacing=(2, 1, 1), sp_size=8, sp_regul=0.2,
        gc_regul=0.1, device='cpu', debug_visual=debug)
    assert segm.shape == shape and segm.dtype == np.int64
    want = np.unpackbits(fx['segm_bits'])[:segm.size].reshape(shape)
    assert adjusted_rand_score(segm, want) >= 0.98
    assert (debug['slic'][fx['slices']] == fx['slic']).mean() >= 0.999
    # every supervoxel has JAX's voxel set, so the features compare 1:1
    digest = segment_digest(debug['slic'], fx['features'].shape[0])
    np.testing.assert_array_equal(digest, fx['digest'])
    # standardised features: mean and energy within rtol 1e-5; the std
    # column's spread over the supervoxels is ~2e-3 (the noise level
    # everywhere), so standardising scales its ~1e-5 sum-order differences
    # (sqrt(E[v^2] - E[v]^2) cancels) by ~500
    got, want = debug['features'], fx['features']
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-2)
    x = torch.as_tensor(fx['features'])
    w = torch.as_tensor(fx['mask'])
    jm = class_model_from_numpy({k: fx[k] for k in (
        'weights', 'means', 'covs', 'scaler_mean', 'scaler_scale')})
    tm = estim_class_model(x, 2, 'GMM', sample_weight=w, seed=0)
    ll_j = float(tgmm.gmm_score(jm.gmm, jm.transform(x), w))
    ll_t = float(tgmm.gmm_score(tm.gmm, tm.transform(x), w))
    assert abs(ll_t - ll_j) <= 1e-3 * abs(ll_j)
    assert isinstance(debug['model'], type(tm))


def test_segment_digest_marks_the_labels_that_differ():
    """Moving one voxel to another label, or swapping two voxels between
    two labels (counts kept), changes the rows of exactly those labels."""
    lab = np.random.default_rng(11).integers(0, 6, (5, 7, 9))
    want = segment_digest(lab, 6)
    np.testing.assert_array_equal(want[:, 0], np.bincount(lab.ravel()))
    moved = lab.copy().reshape(-1)
    moved[17] = (moved[17] + 1) % 6
    i = int(np.flatnonzero(lab.reshape(-1) != lab.reshape(-1)[40])[0])
    swapped = lab.copy().reshape(-1)
    swapped[[i, 40]] = swapped[[40, i]]
    for other, labels in ((moved, {lab.flat[17], moved[17]}),
                          (swapped, {lab.flat[i], lab.flat[40]})):
        differs = np.any(segment_digest(other, 6) != want, axis=1)
        assert set(np.flatnonzero(differs)) == labels


def test_pipe_gray3d_needs_a_card_or_device_cpu():
    vol = sample_gray_volume_3d((4, 24, 30))[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpipe.pipe_gray3d_slic_features_model_graphcut(vol, 2, FEATURES)
    segm = tpipe.pipe_gray3d_slic_features_model_graphcut(
        torch.as_tensor(vol), 2, {'color': FLAGS_ALL}, spacing=(2, 1, 1),
        sp_size=6, gc_regul=0.0)
    assert segm.shape == vol.shape and set(np.unique(segm)) <= {0, 1}
