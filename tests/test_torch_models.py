"""PyTorch GMM / ClassModel predict, metrics and samples vs the JAX package.

Model arrays are made from numpy seeds and handed to both packages; the
port's model is built with ``class_model_from_numpy`` from the arrays of a
JAX ``ClassModel``, the way a fitted model is carried over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.models import class_model as jcm
from pyimsegm_tpu.models import gmm as jgmm
from pyimsegm_tpu.utils import data_samples as jsamples
from pyimsegm_tpu.utils import metrics as jmetrics
from pyimsegm_tpu_torch.models import class_model as tcm
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.utils import data_samples as tsamples
from pyimsegm_tpu_torch.utils import metrics as tmetrics

from torch_threads import one_torch_thread  # noqa: F401


def _gmm_arrays(seed, c=3, d=9):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, d, d))
    covs = a @ a.transpose(0, 2, 1) / d + 0.1 * np.eye(d)
    weights = rng.dirichlet(np.ones(c))
    means = rng.normal(size=(c, d))
    return (weights.astype(np.float32), means.astype(np.float32),
            covs.astype(np.float32))


def _jax_model(seed, scaler, pca, d=9):
    rng = np.random.default_rng(100 + seed)
    w, mu, cov = _gmm_arrays(seed, d=d)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return jcm.ClassModel(
        f32(rng.normal(size=d)) if scaler else None,
        f32(rng.uniform(0.5, 2.0, size=d)) if scaler else None,
        f32(q.T) if pca else None,
        f32(rng.normal(scale=0.1, size=d)) if pca else None,
        f32((np.arange(d) < d - 2).astype(np.float32)) if pca else None,
        jgmm.GMMParams(f32(w), f32(mu), f32(cov)))


def _as_numpy(model):
    d = {k: (None if getattr(model, k) is None else np.asarray(getattr(model, k)))
         for k in ('scaler_mean', 'scaler_scale', 'pca_components', 'pca_mean',
                   'pca_mask')}
    d.update(weights=np.asarray(model.gmm.weights),
             means=np.asarray(model.gmm.means), covs=np.asarray(model.gmm.covs))
    return d


@pytest.mark.parametrize('seed', [0, 1])
def test_gmm_predict_proba_matches_jax(seed):
    w, mu, cov = _gmm_arrays(seed)
    x = np.random.default_rng(seed + 50).normal(size=(200, 9)).astype(
        np.float32)
    ref = np.asarray(jgmm.gmm_predict_proba(
        jgmm.GMMParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(cov)),
        jnp.asarray(x)))
    params = tgmm.GMMParams(torch.as_tensor(w), torch.as_tensor(mu),
                            torch.as_tensor(cov))
    out = tgmm.gmm_predict_proba(params, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    lr_ref = np.asarray(jgmm.gmm_log_resp(
        jgmm.GMMParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(cov)),
        jnp.asarray(x)))
    np.testing.assert_allclose(
        tgmm.gmm_log_resp(params, torch.as_tensor(x)).numpy(), lr_ref,
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('scaler,pca', [(True, False), (True, True),
                                        (False, False)])
def test_class_model_matches_jax(scaler, pca):
    jm = _jax_model(3, scaler, pca)
    tm = tcm.class_model_from_numpy(_as_numpy(jm))
    assert isinstance(tm, torch.nn.Module)
    assert tm.n_classes == 3
    x = np.random.default_rng(9).normal(size=(150, 9)).astype(np.float32)
    np.testing.assert_allclose(tm.transform(torch.as_tensor(x)).numpy(),
                               np.asarray(jm.transform(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.predict_proba(torch.as_tensor(x)).numpy(),
                               np.asarray(jm.predict_proba(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(torch.as_tensor(x)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(x))))


def test_class_model_buffers_follow_the_module():
    tm = tcm.class_model_from_numpy(_as_numpy(_jax_model(4, True, False)))
    names = dict(tm.named_buffers())
    assert set(names) == {'scaler_mean', 'scaler_scale', 'weights', 'means',
                          'covs'}
    assert tm.pca_components is None
    tm = tm.to(torch.float64).to(torch.float32)
    assert tm.means.dtype == torch.float32


def test_fixture_model_loads():
    import os
    path = os.path.join(os.path.dirname(__file__), 'data',
                        'torch_port_fixture.npz')
    with np.load(path) as npz:
        d = {k: npz[k] for k in npz.files}
    assert d['segm'].shape == d['slic'].shape == (884, 1200)
    tm = tcm.class_model_from_numpy(d)
    x = np.random.default_rng(0).random((10, 9)).astype(np.float32)
    p = tm.predict_proba(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_adjusted_rand_score_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(30, 40))
    b = np.where(rng.random((30, 40)) < 0.8, a, rng.integers(0, 5, (30, 40)))
    # the JAX contingency table counts in f32, the port's in int64
    ref = jmetrics.adjusted_rand_score(a, b)
    assert tmetrics.adjusted_rand_score(a, b) == pytest.approx(ref, rel=1e-6)
    assert tmetrics.adjusted_rand_score(torch.as_tensor(a),
                                        torch.as_tensor(b)) == \
        pytest.approx(ref, rel=1e-6)
    assert tmetrics.adjusted_rand_score(a, a) == 1.0
    np.testing.assert_array_equal(
        tmetrics.contingency_table(a, b, 4, 5),
        np.asarray(jmetrics.contingency_table(a, b, 4, 5)))


@pytest.mark.parametrize('seed', [0, 7])
def test_sample_image_matches_jax_generator(seed):
    img_t, seg_t = tsamples.sample_color_image_rand_segment((40, 61), 3, seed)
    img_j, seg_j = jsamples.sample_color_image_rand_segment((40, 61), 3, seed)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(seg_t, seg_j)
