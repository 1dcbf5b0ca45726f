"""The port's model fitting vs the JAX package on the CPU: scaler, PCA,
k-means, EM from labels, Otsu, BGM, every ``estim_class_model`` option,
the NaN-restart selection and the float64 refit of collinear features.

Deterministic fits are held to about 1e-5 relative.  The random fits draw
from a ``torch.Generator``, not ``jax.random``, so they are held by the
weighted mean log-likelihood of the fitted mixture and by the ARS of its
hard predictions against the JAX fit on the same features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.models import bgm as jbgm
from pyimsegm_tpu.models import class_model as jcm
from pyimsegm_tpu.models import gmm as jgmm
from pyimsegm_tpu.models import otsu as jotsu
from pyimsegm_tpu_torch.models import bgm as tbgm
from pyimsegm_tpu_torch.models import class_model as tcm
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.models import otsu as totsu
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

from torch_threads import one_torch_thread  # noqa: F401


def _blobs(n=240, d=6, c=3, seed=0):
    """(N, D) features of ``c`` Gaussian blobs and (N,) weights with a few
    empty slots (weight 0, feature rows 0)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(c, d))
    scales = rng.uniform(0.5, 1.5, size=(c, d))
    y = rng.integers(0, c, n)
    x = centres[y] + rng.normal(size=(n, d)) * scales[y]
    w = np.ones(n, np.float32)
    w[rng.choice(n, 12, replace=False)] = 0.0
    x[w == 0] = 0.0
    return x.astype(np.float32), w


@pytest.fixture(scope='module')
def data():
    return _blobs()


def _t(a):
    return torch.as_tensor(np.array(a))


def _params_close(got, want, rtol=1e-5, atol=1e-5):
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=rtol,
                                   atol=atol)


def test_fit_scaler_and_pca_match_jax(data):
    x, w = data
    mj, sj = jcm._fit_scaler(jnp.asarray(x), jnp.asarray(w))
    mt, st = tcm._fit_scaler(_t(x), _t(w))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    xs = (x - np.asarray(mj)) / np.asarray(sj)
    cj, pmj, kj = jcm._fit_pca(jnp.asarray(xs), jnp.asarray(w), 0.9)
    ct, pmt, kt = tcm._fit_pca(_t(xs), _t(w), 0.9)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(pmt.numpy(), np.asarray(pmj), atol=1e-6)
    # eigenvector signs are free: compare projections up to a per-axis sign
    pj = (xs - np.asarray(pmj)) @ np.asarray(cj).T
    pt = (xs - pmt.numpy()) @ ct.numpy().T
    sign = np.sign(np.sum(pj * pt, axis=0))
    np.testing.assert_allclose(pt * sign, pj, rtol=1e-4, atol=1e-4)


def test_kmeans_from_init_centers_matches_jax(data):
    x, w = data
    init = jgmm.quantile_init_centers(jnp.asarray(x), 3)
    np.testing.assert_allclose(
        tgmm.quantile_init_centers(_t(x), 3).numpy(), np.asarray(init),
        rtol=1e-5, atol=1e-6)
    cj, lj = jgmm.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(w), 3, n_iter=10, init_centers=init)
    ct, lt = tgmm.kmeans_fit(None, _t(x), _t(w), 3, n_iter=10,
                             init_centers=_t(init))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_plus_plus_seeds_are_weighted_samples(data):
    x, w = data
    gen = torch.Generator().manual_seed(3)
    cen = tgmm.kmeans_plus_plus_init(gen, _t(x), _t(w), 3, batch=5)
    assert tuple(cen.shape) == (5, 3, x.shape[1])
    kept = x[w > 0]
    for c in cen.reshape(-1, x.shape[1]).numpy():
        assert np.any(np.all(kept == c, axis=1))
    again = tgmm.kmeans_plus_plus_init(torch.Generator().manual_seed(3),
                                       _t(x), _t(w), 3, batch=5)
    assert torch.equal(cen, again)


@pytest.mark.parametrize('max_iter', [1, 99])
def test_gmm_fit_from_labels_matches_jax(data, max_iter):
    x, w = data
    labels = np.arange(x.shape[0]) % 3
    pj = jgmm.gmm_fit_from_labels(jnp.asarray(x), jnp.asarray(labels),
                                  jnp.asarray(w), 3, max_iter=max_iter)
    pt = tgmm.gmm_fit_from_labels(_t(x), _t(labels), _t(w), 3,
                                  max_iter=max_iter)
    _params_close(pt, pj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(tgmm.gmm_score(pt, _t(x), _t(w))),
        float(jgmm.gmm_score(pj, jnp.asarray(x), jnp.asarray(w))), rtol=1e-5)


def test_otsu_matches_jax(data):
    x, w = data
    for i in range(3):
        np.testing.assert_allclose(
            float(totsu.threshold_otsu(_t(x[:, i]), _t(w))),
            float(jotsu.threshold_otsu(jnp.asarray(x[:, i]), jnp.asarray(w))),
            rtol=1e-5)
    np.testing.assert_array_equal(
        totsu.compute_multivariate_otsu(_t(x), _t(w)).numpy(),
        np.asarray(jotsu.compute_multivariate_otsu(jnp.asarray(x),
                                                   jnp.asarray(w))))


def test_gmm_fit_matches_jax_likelihood(data):
    x, w = data
    pj = jgmm.gmm_fit(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w),
                      3, n_init=9)
    pt = tgmm.gmm_fit(torch.Generator().manual_seed(0), _t(x), _t(w), 3,
                      n_init=9)
    sj = float(jgmm.gmm_score(pj, jnp.asarray(x), jnp.asarray(w)))
    st = float(tgmm.gmm_score(pt, _t(x), _t(w)))
    assert abs(st - sj) <= 1e-3 * abs(sj)
    yj = np.argmax(np.asarray(jgmm.gmm_predict_proba(pj, jnp.asarray(x))), -1)
    yt = tgmm.gmm_predict_proba(pt, _t(x)).argmax(-1).numpy()
    assert adjusted_rand_score(yt[w > 0], yj[w > 0]) >= 0.98


def test_bgm_fit_matches_jax_likelihood(data):
    x, w = data
    pj = jbgm.bgm_fit(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w),
                      3, n_init=4)
    pt = tbgm.bgm_fit(torch.Generator().manual_seed(0), _t(x), _t(w), 3,
                      n_init=4)
    sj = float(jgmm.gmm_score(pj, jnp.asarray(x), jnp.asarray(w)))
    st = float(tgmm.gmm_score(pt, _t(x), _t(w)))
    assert abs(st - sj) <= 1e-3 * abs(sj)
    np.testing.assert_allclose(float(pt.weights.sum()), 1.0, rtol=1e-6)


def test_bgm_cavi_from_same_seeds_matches_jax(data, monkeypatch):
    """With the k-means++ seeds handed to both, one CAVI run is
    deterministic and agrees to about 1e-5."""
    x, w = data
    seeds = jgmm.kmeans_plus_plus_init(jax.random.PRNGKey(5), jnp.asarray(x),
                                       jnp.asarray(w), 3)
    monkeypatch.setattr(jbgm, 'kmeans_plus_plus_init',
                        lambda *a, **k: seeds)
    monkeypatch.setattr(tbgm, 'kmeans_plus_plus_init',
                        lambda *a, **k: _t(seeds))
    for diag in (False, True):
        pj = jbgm._cavi_fit_single(None, jnp.asarray(x), jnp.asarray(w), 3, 20,
                                   jnp.float32(1 / 3), jnp.float32(1.0),
                                   jnp.float32(1e-6), diag=diag)
        pt = tbgm._cavi_fit_single(None, _t(x), _t(w), 3, 20, 1 / 3, 1.0,
                                   1e-6, diag=diag)
        _params_close(pt, pj, rtol=1e-4, atol=1e-4)


def test_non_pd_covariance_gives_nan_and_loses_selection(data):
    """JAX's cholesky gives NaN on a covariance that is not positive
    definite, and a NaN restart loses the selection; the port does the
    same without raising."""
    x, w = data
    d = x.shape[1]
    good = tgmm.gmm_fit_from_labels(_t(x), _t(np.arange(len(x)) % 3), _t(w),
                                    3)
    bad_cov = good.covs.clone()
    bad_cov[1] = -torch.eye(d)
    bad = tgmm.GMMParams(good.weights, good.means, bad_cov)
    lp_t = tgmm._chol_log_prob(_t(x), bad.means, bad.covs).numpy()
    lp_j = np.asarray(jgmm._chol_log_prob(jnp.asarray(x),
                                          jnp.asarray(bad.means.numpy()),
                                          jnp.asarray(bad_cov.numpy())))
    np.testing.assert_array_equal(np.isnan(lp_t), np.isnan(lp_j))
    assert np.isnan(lp_t[:, 1]).all() and np.isfinite(lp_t[:, 0]).all()
    both = tgmm.GMMParams(*[torch.stack([b, g]) for b, g in zip(bad, good)])
    scores = tgmm.gmm_score(both, _t(x), _t(w))
    assert torch.isnan(scores[0]) and torch.isfinite(scores[1])
    best = tgmm._select(both, scores)
    assert torch.equal(best.covs, good.covs)


_DETERMINISTIC = ['GMM_Otsu', 'kmeans_quantiles', 'Otsu']
_RANDOM = ['GMM', 'GMM_kmeans', 'kmeans', 'BGM']


@pytest.mark.parametrize('option', _DETERMINISTIC + _RANDOM)
def test_estim_class_model_matches_jax(data, option):
    x, w = data
    nb = 2 if option == 'Otsu' else 3
    jm = jcm.estim_class_model(jnp.asarray(x), nb, option, pca_coef=0.95,
                               sample_weight=jnp.asarray(w))
    tm = tcm.estim_class_model(x, nb, option, pca_coef=0.95, sample_weight=w,
                               device='cpu')
    assert tm.weights.device.type == 'cpu'
    proba_j = np.asarray(jm.predict_proba(jnp.asarray(x)))
    proba_t = tm.predict_proba(_t(x)).numpy()
    if option in _DETERMINISTIC:
        # the PCA axes may flip sign, so hold the fit by what it predicts
        np.testing.assert_allclose(proba_t, proba_j, rtol=1e-4, atol=1e-5)
        return
    xt = tm.transform(_t(x))
    xj = jm.transform(jnp.asarray(x))
    sj = float(jgmm.gmm_score(jm.gmm, xj, jnp.asarray(w)))
    st = float(tgmm.gmm_score(tm.gmm, xt, _t(w)))
    assert abs(st - sj) <= 1e-3 * abs(sj)
    assert adjusted_rand_score(proba_t.argmax(-1)[w > 0],
                               proba_j.argmax(-1)[w > 0]) >= 0.98


def test_estim_class_model_unknown_option_raises(data):
    x, w = data
    with pytest.raises(ValueError):
        tcm.estim_class_model(x, 3, 'nope', device='cpu')
    with pytest.raises(ValueError):
        tcm.estim_class_model(x, 3, 'Otsu', device='cpu')


def _collinear(n=600, d=23, rank=3, seed=0, scale=30.0):
    """Two blobs of rank-3 features in 23 columns, scaled so that a float32
    covariance's rounding (~1e-3) dwarfs ``reg_covar`` (1e-6): every f32
    factor breaks down, a float64 one does not."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    lat = rng.normal(size=(n, rank)) + 4.0 * y[:, None]
    x = scale * (lat @ rng.normal(size=(rank, d)))
    return x.astype(np.float32), np.ones(n, np.float32), y


@pytest.mark.parametrize('fit', ['GMM', 'BGM'])
def test_collinear_features_refit_in_float64(data, fit):
    """Where every f32 restart is NaN (JAX's fit is NaN there too), the port
    refits from the same start in float64: finite, covariances kept in
    float64, and the two blobs separated; ordinary data keeps the f32 fit."""
    x, w, y = _collinear()
    xt, wt = _t(x), _t(w)
    if fit == 'GMM':
        labels = tgmm.kmeans_fit(torch.Generator().manual_seed(0), xt, wt, 2,
                                 n_iter=15, batch=9)[1]
        resp = torch.nn.functional.one_hot(labels, 2).to(torch.float32)
        assert torch.isnan(tgmm._em_fit(xt, wt, 99, 1e-6, resp)[1]).all()
        pj = jgmm.gmm_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(w), 2, n_init=9)
        pt = tgmm.gmm_fit(torch.Generator().manual_seed(0), xt, wt, 2,
                          n_init=9)
    else:
        pj = jbgm.bgm_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(w), 2, n_init=4)
        pt = tbgm.bgm_fit(torch.Generator().manual_seed(0), xt, wt, 2,
                          n_init=4)
    assert np.isnan(np.asarray(pj.covs)).any()
    assert pt.covs.dtype == torch.float64
    assert pt.weights.dtype == pt.means.dtype == torch.float32
    assert all(bool(torch.isfinite(a).all()) for a in pt)
    proba = tgmm.gmm_predict_proba(pt, xt)
    assert proba.dtype == torch.float32 and torch.isfinite(proba).all()
    assert adjusted_rand_score(proba.argmax(-1).numpy(), y) >= 0.98
    model = tcm.estim_class_model(x, 2, fit, use_scaler=False, device='cpu')
    assert model.covs.dtype == torch.float64
    assert adjusted_rand_score(model.predict(xt).numpy(), y) >= 0.98
    xd, wd = data
    fits = {'GMM': tgmm.gmm_fit, 'BGM': tbgm.bgm_fit}
    ordinary = fits[fit](torch.Generator().manual_seed(0), _t(xd), _t(wd), 3)
    assert ordinary.covs.dtype == torch.float32
