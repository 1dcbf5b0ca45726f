"""The port's boosted trees vs the JAX package on the CPU: gradient-boosted
trees (a deterministic fit, held to JAX's trees) and AdaBoost (random
trees, held by accuracy), and both predictions with carried parameters.

The GBT fit's histograms are float64 sums in another order than JAX's f32
segment sums.  Two splits that send the same training samples left and
right (or the same samples with the sides swapped, as ``x_1 < a`` and
``x_5 < b`` can) have equal gains up to that rounding, and JAX's own
rounding picks one of them: at such an exact tie the port may store the
other feature and threshold.  The tests hold every tree by what it does
with the training samples: the same partition into leaves (up to the order
of the leaves) with the same leaf values (rtol 1e-4), and they count the
nodes whose feature and threshold are equal too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu.models import adaboost as jada
from pyimsegm_tpu.models import gbt as jgbt
from pyimsegm_tpu_torch.models import adaboost as tada
from pyimsegm_tpu_torch.models import gbt as tgbt

from torch_threads import one_torch_thread  # noqa: F401


def _scene(name):
    """(x, y, w) of a test scene: Gaussian blobs, or noisy pixel colours of
    overlapping classes; a few padded rows of weight 0."""
    rng = np.random.default_rng(0)
    if name == 'blobs':
        centres = rng.normal(scale=2.0, size=(3, 6))
        x = np.concatenate([c + rng.normal(scale=1.5, size=(80, 6))
                            for c in centres])
        y = np.repeat(np.arange(3), 80)
    else:
        x = rng.random((300, 3)) + rng.normal(scale=0.2, size=(300, 3))
        y = (x[:, 0] + x[:, 1] > 1.0).astype(int) + (x[:, 2] > 0.7)
    w = np.ones(len(x), np.float32)
    w[-10:] = 0.0
    return x.astype(np.float32), y.astype(np.int32), w


def _t(a):
    return torch.as_tensor(np.array(a))


def _leaf_partition(feat, thr, depth, x):
    """(R, C, N) leaf id of every sample in every tree."""
    r, c, _ = feat.shape
    return np.asarray(tgbt._walk(_t(feat).reshape(1, r * c, -1),
                                 _t(thr).reshape(1, r * c, -1), depth,
                                 _t(x)[None])).reshape(r, c, -1)


def _same_trees(pj, pt, x, w):
    """Each tree's partition of the training samples into leaves equal up
    to the leaves' order, with equal leaf values (rtol 1e-4); returns the
    share of nodes with an equal (feature, threshold)."""
    depth = int(pj.depth)
    lj = _leaf_partition(np.asarray(pj.feat), np.asarray(pj.thr), depth, x)
    lt = _leaf_partition(pt.feat.numpy(), pt.thr.numpy(), depth, x)
    leaf_j, leaf_t = np.asarray(pj.leaf), pt.leaf.numpy()
    real = w > 0
    for r in range(lj.shape[0]):
        for c in range(lj.shape[1]):
            a, b = lj[r, c][real], lt[r, c][real]
            pairs = set(zip(a.tolist(), b.tolist()))
            # a bijection between the leaves the samples reach
            assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))
            for ia, ib in pairs:
                np.testing.assert_allclose(leaf_t[r, c, ib], leaf_j[r, c, ia],
                                           rtol=1e-4, atol=1e-6)
    same = (np.asarray(pj.feat) == pt.feat.numpy()) \
        & (np.asarray(pj.thr) == pt.thr.numpy())
    return float(same.mean())


@pytest.mark.parametrize('scene', ['blobs', 'pixels'])
def test_gbt_fit_matches_jax(scene):
    x, y, w = _scene(scene)
    kw = dict(n_rounds=24, depth=4, n_bins=32)
    pj = jgbt.gbt_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 3,
                      **kw)
    pt = tgbt.gbt_fit(_t(x), _t(y), _t(w), 3, **kw)
    share = _same_trees(pj, pt, x, w)
    print('GBT on %s: %.4f of the nodes with an equal feature and threshold'
          % (scene, share))
    assert share >= 0.9
    np.testing.assert_allclose(pt.base_score.numpy(),
                               np.asarray(pj.base_score), rtol=1e-6)
    want = np.asarray(jgbt.gbt_predict_proba(pj, jnp.asarray(x)))
    got = tgbt.gbt_predict_proba(pt, _t(x)).numpy()
    np.testing.assert_allclose(got[w > 0], want[w > 0], atol=1e-4)


def _carried(pj):
    return tgbt.GBTParams(_t(np.asarray(pj.feat, np.int64)), _t(pj.thr),
                          _t(pj.leaf), _t(pj.base_score),
                          float(pj.learning_rate), int(pj.depth))


def test_gbt_predict_with_carried_parameters():
    x, y, w = _scene('blobs')
    pj = jgbt.gbt_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 3,
                      n_rounds=16, depth=3)
    xq = x + np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want = np.asarray(jgbt.gbt_predict_proba(pj, jnp.asarray(xq)))
    got = tgbt.gbt_predict_proba(_carried(pj), _t(xq)).numpy()
    print('GBT carried proba max diff %.3g' % np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_gbt_fold_batched_fit_equals_single_folds():
    x, y, w = _scene('pixels')
    folds = np.stack([w, (np.arange(len(w)) % 3 != 0).astype(np.float32)])
    kw = dict(n_rounds=8, depth=3, n_bins=16)
    pb = tgbt.gbt_fit(_t(x), _t(y), _t(folds), 3, **kw)
    for b in range(2):
        p1 = tgbt.gbt_fit(_t(x), _t(y), _t(folds[b]), 3, **kw)
        for got, want in zip(pb[:4], p1[:4]):
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    raw = tgbt._gbt_raw_scores(pb.feat, pb.thr, pb.leaf, pb.base_score, 0.1,
                               3, _t(np.stack([x, x])))
    want = tgbt._gbt_raw_scores(p1.feat, p1.thr, p1.leaf, p1.base_score,
                                0.1, 3, _t(x))
    torch.testing.assert_close(raw[1], want, rtol=0, atol=0)


def test_gbt_fit_is_deterministic():
    x, y, w = _scene('pixels')
    a, b = (tgbt.gbt_fit(_t(x), _t(y), _t(w), 3, n_rounds=8, depth=3)
            for _ in range(2))
    for pa, pb in zip(a[:4], b[:4]):
        assert torch.equal(pa, pb)


def test_adaboost_fit_accuracy_matches_jax():
    """The rounds' trees draw different random numbers: training and
    held-out accuracy within 0.02 of JAX's."""
    x, y, w = _scene('pixels')
    xt, yt, _ = _scene('pixels')
    xt = xt + np.random.default_rng(3).normal(scale=0.1, size=xt.shape) \
        .astype(np.float32)
    pj = jada.adaboost_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(w), 3, n_rounds=12)
    pt = tada.adaboost_fit(torch.Generator().manual_seed(0), _t(x), _t(y),
                           _t(w), 3, n_rounds=12)
    for xs, ys in ((x, y), (xt, yt)):
        acc_j = float(np.mean(np.argmax(np.asarray(jada.adaboost_predict_proba(
            pj, jnp.asarray(xs))), 1) == ys))
        acc_t = float(np.mean(np.argmax(tada.adaboost_predict_proba(
            pt, _t(xs)).numpy(), 1) == ys))
        print('AdaBoost accuracy: JAX %.4f, port %.4f' % (acc_j, acc_t))
        assert acc_t >= acc_j - 0.02


def test_adaboost_predict_with_carried_parameters_both_clips():
    """``adaboost_predict_proba`` clips at 1e-7, the pipeline's predict at
    1e-10: a tree leaf of probability 0 makes them differ, and each equals
    JAX's own within 1e-6."""
    from pyimsegm_tpu import classification as jclf
    from pyimsegm_tpu_torch import classification as tclf
    x, y, w = _scene('blobs')
    pj = jada.adaboost_fit(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(w), 3, n_rounds=6)
    assert float(np.min(np.asarray(pj.leaf_proba))) == 0.0
    pt = tada.AdaBoostParams(_t(np.asarray(pj.feat, np.int64)), _t(pj.thr),
                             _t(pj.leaf_proba), int(pj.depth))
    xq = x + np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    want7 = np.asarray(jada.adaboost_predict_proba(pj, jnp.asarray(xq)))
    got7 = tada.adaboost_predict_proba(pt, _t(xq)).numpy()
    np.testing.assert_allclose(got7, want7, rtol=0, atol=1e-6)
    cj = jclf.Classifier('AdaBoost')
    cj.classes_, cj._params = np.arange(3), pj
    cj._scaler = (np.zeros(x.shape[1], np.float32),
                  np.ones(x.shape[1], np.float32))
    apply, arrays = cj.device_predict_fn()
    want10 = np.asarray(apply(arrays, jnp.asarray(xq)))
    got10 = tada.adaboost_scores_proba(
        pt.feat, pt.thr, pt.leaf_proba, pt.depth, _t(xq),
        eps=tclf.PIPELINE_ADABOOST_EPS).numpy()
    np.testing.assert_allclose(got10, want10, rtol=0, atol=1e-6)
    print('AdaBoost clips 1e-7 vs 1e-10: proba max diff %.3g'
          % np.abs(want7 - want10).max())
    assert np.abs(want7 - want10).max() > 1e-3
