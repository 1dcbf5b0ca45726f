"""The port's centre detection (BASELINE config 4) vs the JAX package on
the CPU: ray features and their phase alignment, the clustering module,
the eps-graph components, the ``centers`` helpers, and
``load_compute_detect_centers`` through its fused and its staged route
with a forest trained by JAX and carried across; then the committed
647x1024 fixture that ``chip_smoke.py`` holds the card to.

Bars: SLIC labels >= 0.999 equal; points and label histograms exact; ray
distances equal on >= 0.999 of (position, angle) entries, any other
differing by one step length; shifts equal on >= 0.99 of the rows (the
FFT's rounding breaks exact ties of harmonics, e.g. of a ray with one
hit, another way than XLA's), aligned rays equal on those rows; clustered
centres one to one within 1 px; DBSCAN and the components exact;
mean-shift modes within 1e-3 of the bandwidth; spectral clustering ARS >=
0.98 (the k-means generators differ)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import centers as jctr
from pyimsegm_tpu.models import clustering as jclu
from pyimsegm_tpu.ops import ray as jray
from pyimsegm_tpu.ops.slic import segment_slic_img2d
from pyimsegm_tpu_torch import centers as tctr
from pyimsegm_tpu_torch.classification import classifier_from_numpy
from pyimsegm_tpu_torch.models import clustering as tclu
from pyimsegm_tpu_torch.ops import ray as tray
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
from make_torch_port_fixture import (CENTER_TEST_SEED, N_EGGS,  # noqa: E402
                                     OUT_CENTERS, OVARY, _clf_arrays)

SIZE = (128, 160)
#: tests/test_centers.py's parameters of the chain at the test size
PARAMS = dict(jctr.CENTER_PARAMS, slic_size=10, slic_regul=0.3,
              fts_hist_diams=[4, 8, 16], fts_ray_step=30,
              center_dist_thr=8, nb_classif_search=1)
RAY_BAR, SHIFT_BAR, SLIC_BAR = 0.999, 0.99, 0.999


@pytest.fixture(scope='module')
def scenes():
    """Three training scenes and a test scene of two eggs at 128x160."""
    return [sample_ovary_scene(SIZE, 2, rand_seed=s) for s in range(4)]


@pytest.fixture(scope='module')
def forest(scenes):
    """The forest JAX trains on the three training scenes, and its port."""
    clf, _ = jctr.train_center_classifier(
        [s[1] for s in scenes[:3]], [s[0] for s in scenes[:3]],
        [s[2] for s in scenes[:3]], PARAMS)
    return clf, classifier_from_numpy(_clf_arrays(clf), device='cpu')


@pytest.fixture(scope='module')
def slic_points(scenes):
    """Candidate points of the test scene: its SLIC centres (JAX)."""
    img, segm, _ = scenes[3]
    slic = np.asarray(segment_slic_img2d(img, sp_size=10,
                                         relative_compact=0.3))
    from pyimsegm_tpu import superpixels
    return superpixels.superpixel_centers(slic)


def _hold_rays(got, want, step_len):
    """>= RAY_BAR of the entries equal, the others one step length off."""
    same = got == want
    assert same.mean() >= RAY_BAR, same.mean()
    np.testing.assert_allclose(np.abs(got - want)[~same],
                               np.broadcast_to(step_len, got.shape)[~same],
                               rtol=1e-6)


def _hold_shifts(got, want, got_shift, want_shift):
    """>= SHIFT_BAR of the rows with equal shifts, their rays equal."""
    rows = np.abs(got_shift - want_shift) <= 1e-3
    assert rows.mean() >= SHIFT_BAR, rows.mean()
    np.testing.assert_array_equal(got[rows], want[rows])


@pytest.mark.parametrize('edge,labels,step', [
    ('up', (0,), 30.0), ('up', (0,), 15.0), ('down', (1,), 5.0),
    ('down', (1, 2), 15.0)])
def test_ray_core_and_shift(scenes, slic_points, edge, labels, step):
    """The ray march at the SLIC centres and the true centres, and the
    batched alignment of its rays, against JAX."""
    _, segm, centres = scenes[3]
    seg_b = np.isin(segm, labels)
    pos = np.concatenate([slic_points, centres]).astype(np.float32)
    want = np.array(jray.ray_features_positions_core(
        jnp.asarray(seg_b), jnp.asarray(pos), angle_step=step, edge=edge))
    got = tray.ray_features_positions_core(
        torch.as_tensor(seg_b), torch.as_tensor(pos), angle_step=step,
        edge=edge).numpy()
    grad = tray._ray_directions(step)[1].numpy()
    _hold_rays(got, want, np.sqrt((grad * grad).sum(1)))
    assert (got == -1).any() or edge == 'up'
    aligned_j, shift_j = jray.shift_ray_features_batched(jnp.asarray(want))
    aligned_t, shift_t = tray.shift_ray_features_batched(torch.as_tensor(want))
    _hold_shifts(aligned_t.numpy(), np.asarray(aligned_j), shift_t.numpy(),
                 np.asarray(shift_j))


def test_ray_host_helpers(scenes, slic_points):
    """``compute_ray_features_positions`` (with an opening and a smoothing),
    the single-position call, the numpy alignment, interpolation,
    back-projection and thinning: JAX's results."""
    _, segm, centres = scenes[3]
    pts = slic_points[::7]
    for kw in ({},
               {'segm_open': 2, 'smooth_ray': 1.0, 'border_labels': [0, 3]},
               {'shifting': False, 'edge': 'down', 'border_labels': [1]}):
        rj, sj, nj = jray.compute_ray_features_positions(segm, pts, 30, **kw)
        rt, st, nt = tray.compute_ray_features_positions(segm, pts, 30,
                                                         device='cpu', **kw)
        assert nt == nj
        np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st, sj, atol=1e-4)
    ray = tray.compute_ray_features_segm_2d(segm == 0, centres[0], 10,
                                            device='cpu')
    np.testing.assert_array_equal(
        ray, jray.compute_ray_features_segm_2d(segm == 0, centres[0], 10))
    for method in ('phase', 'max'):
        got, want = (tray.shift_ray_features(ray, method),
                     jray.shift_ray_features(ray, method))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    gappy = ray.astype(float)
    gappy[[3, 4, 20]] = -1
    for order in (2, 'spline', 'cos'):
        np.testing.assert_array_equal(tray.interpolate_ray_dist(gappy, order),
                                      jray.interpolate_ray_dist(gappy, order))
    back = tray.reconstruct_ray_features_2d(centres[0], gappy, 12)
    np.testing.assert_array_equal(
        back, jray.reconstruct_ray_features_2d(centres[0], gappy, 12))
    np.testing.assert_array_equal(tray.reduce_close_points(back, 6),
                                  jray.reduce_close_points(back, 6))


def test_pairwise_dbscan_components():
    """Squared distances within rtol 1e-5; DBSCAN labels at two
    ``min_samples`` exact; the fused chain's eps-graph components equal
    the min index of JAX's DBSCAN clusters over the candidates."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 8, (30, 2))
                          for c in ((20, 30), (90, 40), (60, 150))])
    np.testing.assert_allclose(
        tclu.pairwise_dist2(pts, pts[:7], device='cpu').numpy(),
        np.asarray(jclu.pairwise_dist2(pts, pts[:7])), rtol=1e-5, atol=1e-3)
    for eps, ms in ((9.0, 1), (6.0, 4)):
        np.testing.assert_array_equal(
            tclu.dbscan(pts, eps, ms, device='cpu'),
            jclu.dbscan(pts, eps, ms))
    cand = rng.random(len(pts)) > 0.3
    comp = tctr.eps_components(torch.as_tensor(pts, dtype=torch.float32),
                               torch.as_tensor(cand), 9.0).numpy()
    lab = jclu.dbscan(pts[cand], 9.0, 1)
    idx = np.nonzero(cand)[0]
    want = np.full(len(pts), len(pts))
    for c in np.unique(lab):
        want[idx[lab == c]] = idx[lab == c].min()
    np.testing.assert_array_equal(comp, want)


def test_mean_shift_bandwidth_spectral():
    """Bandwidth within rtol 1e-5, mean-shift modes within 1e-3 x
    bandwidth with equal labels, spectral clustering ARS >= 0.98."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(c, 1.0, (25, 2))
                          for c in ((0, 0), (10, 0), (0, 12))])
    bw = tclu.estimate_bandwidth(pts, device='cpu')
    assert bw == pytest.approx(jclu.estimate_bandwidth(pts), rel=1e-5)
    modes_t, lab_t = tclu.mean_shift(pts, 3.0, device='cpu')
    modes_j, lab_j = jclu.mean_shift(pts, 3.0)
    assert modes_t.shape == modes_j.shape
    np.testing.assert_allclose(modes_t, modes_j, atol=1e-3 * 3.0)
    np.testing.assert_array_equal(lab_t, lab_j)
    spec_t = tclu.spectral_clustering(pts, 3, seed=0, device='cpu')
    spec_j = jclu.spectral_clustering(pts, 3, seed=0)
    assert adjusted_rand_score(spec_t, spec_j) >= 0.98


def test_centre_helpers(scenes, slic_points):
    """Point features (histograms exact, rays by their bars), labels of
    close points, distances to centres, DBSCAN merge and the evaluation:
    JAX's."""
    _, segm, centres = scenes[3]
    params = dict(PARAMS, fts_ray_types=[('up', [0]), ('down', [1])])
    for prm in (PARAMS, params):
        ft, nt = tctr.compute_points_features(segm, slic_points, prm,
                                              device='cpu')
        fj, nj = jctr.compute_points_features(segm, slic_points, prm)
        assert nt == nj
        n_hist = sum(n.startswith('hist') for n in nj)
        np.testing.assert_array_equal(ft[:, :n_hist], fj[:, :n_hist])
        assert (ft[:, n_hist:] == fj[:, n_hist:]).mean() >= RAY_BAR
    cl = list(map(tuple, centres))
    np.testing.assert_array_equal(
        tctr.label_close_points(cl, slic_points, PARAMS, device='cpu'),
        jctr.label_close_points(cl, slic_points, PARAMS))
    mask = np.zeros(SIZE, int)
    mask[tuple(slic_points[3].astype(int))] = 5
    np.testing.assert_array_equal(
        tctr.label_close_points(mask, slic_points, PARAMS),
        jctr.label_close_points(mask, slic_points, PARAMS))
    assert tctr.label_close_points([], slic_points, PARAMS).sum() == 0
    dt, at = tctr.compute_min_dist_2_centers(cl, slic_points, device='cpu')
    dj, aj = jctr.compute_min_dist_2_centers(cl, slic_points)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(at, aj)
    ct, lt = tctr.cluster_center_candidates(slic_points[:40], 15,
                                            device='cpu')
    cj, lj = jctr.cluster_center_candidates(slic_points[:40], 15)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(lt, lj)
    for det in ([], centres[:1] + 3, np.concatenate([centres, [[5, 5]]])):
        for true in (centres, []):
            assert tctr.evaluate_detected_centers(det, true, 8, 'cpu') == \
                pytest.approx(jctr.evaluate_detected_centers(det, true, 8))


def _hold_centres(got, want):
    """One to one within 1 px."""
    got, want = np.asarray(got).reshape(-1, 2), np.asarray(want).reshape(-1, 2)
    assert got.shape == want.shape
    if len(want):
        d = np.sqrt(((got[:, None] - want[None]) ** 2).sum(-1))
        assert (d.min(axis=1) <= 1).all() and (d.min(axis=0) <= 1).all()
        assert (np.argmin(d, axis=1)[np.argmin(d, axis=0)]
                == np.arange(len(want))).all()


class _HostModel:
    """A classifier the fused route does not take: numpy in, numpy out."""

    def __init__(self, clf):
        self.clf = clf
        self.classes_ = np.asarray(clf.classes_)

    def predict_proba(self, x):
        return np.asarray(self.clf.predict_proba(x))

    def predict(self, x):
        return np.asarray(self.clf.predict(x))


@pytest.mark.parametrize('route', ['fused', 'staged'])
def test_detect_centers_matches_jax(scenes, forest, route):
    """``load_compute_detect_centers`` through each route with the forest
    trained by JAX: SLIC labels, points, candidates and centres against
    JAX's through the same route."""
    img, segm, _ = scenes[3]
    jclf, tclf = forest
    if route == 'staged':
        jclf, tclf = _HostModel(jclf), _HostModel(tclf)
    want = jctr.load_compute_detect_centers(img, segm, jclf, PARAMS)
    got = tctr.load_compute_detect_centers(img, segm, tclf, PARAMS,
                                           device='cpu')
    assert tctr._fused_ok(tclf, dict(PARAMS, **tctr.CLUSTER_PARAMS)) == \
        (route == 'fused')
    assert (got['slic'] == np.asarray(want['slic'])).mean() >= SLIC_BAR
    np.testing.assert_array_equal(got['points'], np.asarray(want['points']))
    _hold_centres(got['candidates'], want['candidates'])
    _hold_centres(got['centers'], want['centers'])
    assert len(got['candidates']) > 0
    np.testing.assert_array_equal(got['clust_labels'],
                                  np.asarray(want['clust_labels']))


def test_committed_centers_fixture():
    """The fused route at 647x1024 on the fixture's test scene with its
    JAX-trained forest, against the JAX-CPU outputs that chip_smoke.py
    holds the card to."""
    with np.load(OUT_CENTERS) as npz:
        fx = {k: npz[k] for k in npz.files}
    clf = classifier_from_numpy({k[4:]: v for k, v in fx.items()
                                 if k.startswith('clf_')}, device='cpu')
    img, segm, centres = sample_ovary_scene(OVARY, N_EGGS,
                                            rand_seed=CENTER_TEST_SEED)
    got = tctr.load_compute_detect_centers(img, segm, clf, device='cpu')
    assert (got['slic'] == fx['slic']).mean() >= SLIC_BAR
    np.testing.assert_array_equal(got['points'], fx['points'])
    _hold_centres(got['candidates'], fx['candidates'])
    _hold_centres(got['centers'], fx['centers'])
    stats = tctr.evaluate_detected_centers(got['centers'], centres, 50, 'cpu')
    assert stats['recall'] >= float(fx['recall'])
    assert stats['precision'] >= float(fx['precision'])
