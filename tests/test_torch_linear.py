"""The port's linear and neural classifiers vs the JAX package on the CPU:
logistic regression and the linear SVM (deterministic fits, held to JAX's
parameters), the MLP (its Adam loop from JAX's init held to JAX's
parameters; its seeded fit by accuracy), kNN (exact on tie-free data), and
each prediction with carried parameters.

The MLP loop matches JAX's to ~1e-6 for its first 200 steps.  Later, one
hidden unit's pre-activation can cross 0 on a training sample one step
apart in the two runs (their gradients differ in the last bits), and Adam's
normalised steps of lr = 0.01 carry that on: at the default 500 steps the
parameters differ by up to ~1e-2 while the accuracies agree.  So the loop
is held at 200 steps, and the 500-step fit by accuracy and probability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.models import linear as jlin
from pyimsegm_tpu_torch.models import linear as tlin

from torch_threads import one_torch_thread  # noqa: F401

N_CLASSES = 3


@pytest.fixture(scope='module')
def scene():
    """(x, y, w) of overlapping Gaussian classes with a few zero-weight
    rows, and held-out query points."""
    rng = np.random.default_rng(0)
    n, f = 300, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = np.argmax(x[:, :3] + 0.5 * rng.normal(size=(n, 3)), 1)
    w = np.ones(n, np.float32)
    w[-20:] = 0.0
    q = rng.normal(size=(80, f)).astype(np.float32)
    return x, y.astype(np.int32), w, q


def _t(a):
    return torch.as_tensor(np.array(a))


def _gen():
    return torch.Generator().manual_seed(0)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('name', ['LogistRegr', 'SVM'])
def test_linear_fit_matches_jax(scene, name):
    """w, b after the default steps within rtol 1e-4 + atol 1e-5; the fold
    batch equals the single fits."""
    x, y, w, q = scene
    jfit, tfit = ((jlin.logistic_fit, tlin.logistic_fit) if name ==
                  'LogistRegr' else (jlin.linear_svm_fit,
                                     tlin.linear_svm_fit))
    pj = jfit(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
              jnp.asarray(w), N_CLASSES)
    pt = tfit(_gen(), _t(x), _t(y), _t(w), N_CLASSES)
    print('%s fit: w max diff %.3g, b max diff %.3g' % (
        name, np.abs(pt.w.numpy() - np.asarray(pj.w)).max(),
        np.abs(pt.b.numpy() - np.asarray(pj.b)).max()))
    _close(pt.w, pj.w)
    _close(pt.b, pj.b)
    want = np.asarray(jlin.logistic_predict_proba(pj, jnp.asarray(q)))
    got = tlin.logistic_predict_proba(tlin.LinearParams(_t(pj.w), _t(pj.b)),
                                      _t(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    folds = np.stack([w, (np.arange(len(w)) % 4 != 0).astype(np.float32)])
    pb = tfit(_gen(), _t(x), _t(y), _t(folds), N_CLASSES, steps=50)
    p1 = tfit(_gen(), _t(x), _t(y), _t(folds[1]), N_CLASSES, steps=50)
    torch.testing.assert_close(pb.w[1], p1.w, rtol=1e-6, atol=1e-7)


def _jax_init(key, f, hidden):
    """The JAX package's He init of ``mlp_fit``."""
    k1, k2 = jax.random.split(key)
    return tlin.MLPParams(
        _t(jax.random.normal(k1, (f, hidden)) * jnp.sqrt(2.0 / f)),
        torch.zeros(hidden),
        _t(jax.random.normal(k2, (hidden, N_CLASSES))
           * jnp.sqrt(2.0 / hidden)),
        torch.zeros(N_CLASSES))


def test_mlp_train_from_jax_init_matches_jax(scene):
    x, y, w, q = scene
    key = jax.random.PRNGKey(0)
    pj = jlin.mlp_fit(key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                      N_CLASSES, steps=200)
    pt = tlin.mlp_train(_jax_init(key, x.shape[1], 64), _t(x), _t(y), _t(w),
                        N_CLASSES, steps=200)
    print('MLP loop from the JAX init, 200 steps: max diffs %s'
          % [float(np.abs(b.numpy() - np.asarray(a)).max())
             for a, b in zip(pj, pt)])
    for a, b in zip(pj, pt):
        _close(b, a)
    want = np.asarray(jlin.mlp_predict_proba(pj, jnp.asarray(q)))
    got = tlin.mlp_predict_proba(tlin.MLPParams(*(_t(a) for a in pj)), _t(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_mlp_fit_accuracy_matches_jax(scene):
    """The seeded fits start from different draws: accuracy on the training
    set and on held-out points within 0.02 of JAX's (default 500 steps; and
    from JAX's init, the probabilities within 0.02)."""
    x, y, w, q = scene
    qy = np.argmax(q[:, :3], 1)
    key = jax.random.PRNGKey(0)
    pj = jlin.mlp_fit(key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                      N_CLASSES)
    pt = tlin.mlp_fit(torch.Generator().manual_seed(0), _t(x), _t(y), _t(w),
                      N_CLASSES)
    for xs, ys in ((x, y), (q, qy)):
        acc_j = float(np.mean(np.argmax(np.asarray(jlin.mlp_predict_proba(
            pj, jnp.asarray(xs))), 1) == ys))
        acc_t = float(np.mean(np.argmax(tlin.mlp_predict_proba(
            pt, _t(xs)).numpy(), 1) == ys))
        print('MLP accuracy: JAX %.4f, port %.4f' % (acc_j, acc_t))
        assert acc_t >= acc_j - 0.02
    from_init = tlin.mlp_train(_jax_init(key, x.shape[1], 64), _t(x), _t(y),
                               _t(w), N_CLASSES)
    diff = np.abs(tlin.mlp_predict_proba(from_init, _t(q)).numpy()
                  - np.asarray(jlin.mlp_predict_proba(pj, jnp.asarray(q))))
    print('MLP 500 steps from the JAX init: proba max diff %.3g'
          % diff.max())
    assert diff.max() <= 0.02


def test_knn_exact_on_tie_free_data(scene):
    """Distances of continuous random points have no ties: the neighbours,
    and so the votes, are JAX's; zero-weight training rows never vote."""
    x, y, w, q = scene
    for k in (1, 5, 15):
        pj = jlin.knn_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                          N_CLASSES, k=k)
        pt = tlin.knn_fit(_t(x), _t(y), _t(w), N_CLASSES, k=k)
        want = np.asarray(jlin.knn_predict_proba(pj, jnp.asarray(q)))
        got = tlin.knn_predict_proba(pt, _t(q)).numpy()
        np.testing.assert_array_equal(got, want)
    # a query on a zero-weight row takes its votes from the others
    got = tlin.knn_predict_proba(pt, _t(x[-20:]))
    own = tlin.knn_predict_proba(tlin.knn_fit(_t(x), _t(y), torch.ones(
        len(x)), N_CLASSES, k=1), _t(x[-20:]))
    assert torch.equal(own, torch.nn.functional.one_hot(
        _t(y[-20:]).long(), N_CLASSES).float())
    assert got.shape == (20, N_CLASSES)
