"""The ported slices end to end vs the JAX package on the CPU:
``segment_color2d_slic_features_model_graphcut`` with ``connectivity=False``
and at its default ``connectivity=True``, with one fitted GMM class model
handed to both packages, and with a duck-typed numpy model; the
unsupervised fit path
(``pipe_color2d_slic_features_model_graphcut``,
``estim_model_classes_group``, ``compute_color2d_superpixels_features``)
with the full colour feature set; ``segment_slic_img2d`` with and without
SLICO; and the 'color' edge weights."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import pipelines as jpipe
from pyimsegm_tpu import superpixels as jsp
from pyimsegm_tpu.models.class_model import estim_class_model
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch import superpixels as tsp
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.parallel import batch as tbatch
from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP, REGUL, GC = 16, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
FEATURES_ALL = {'color': ['mean', 'std', 'energy', 'median', 'meanGrad']}
SPEC = jpipe._features_spec(FEATURES)
SHAPES = [(96, 140), (101, 133)]


def _image(shape, seed):
    return sample_color_image_rand_segment(shape, 3, rand_seed=seed)[0]


def _same_superpixels(labels_a, labels_b, k):
    diff = labels_a != labels_b
    touched = np.zeros(k, bool)
    touched[labels_a[diff]] = True
    touched[labels_b[diff]] = True
    return ~touched


@pytest.fixture(scope='module')
def models():
    """A GMM fitted by the JAX package on two images, and its port."""
    cfg = jslic.slic_config(*SHAPES[0], SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    feats, masks = [], []
    for seed in (0, 1):
        _, f, counts, _ = jpipe._slic_features_core(
            jnp.asarray(_image(SHAPES[0], seed)), cfg, SPEC, m,
            connectivity=False)
        feats.append(f)
        masks.append((counts > 0).astype(jnp.float32))
    jm = estim_class_model(jnp.concatenate(feats), 3, 'GMM',
                           sample_weight=jnp.concatenate(masks))
    arrays = {'weights': jm.gmm.weights, 'means': jm.gmm.means,
              'covs': jm.gmm.covs, 'scaler_mean': jm.scaler_mean,
              'scaler_scale': jm.scaler_scale}
    return jm, class_model_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()})


def _check_slic_features_core(shape, connectivity):
    img = _image(shape, 2)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    ref = jpipe._slic_features_core(jnp.asarray(img), cfg, SPEC, m,
                                    connectivity=connectivity)
    out = tpipe._slic_features_core(torch.as_tensor(img),
                                    tslic.slic_config(*shape, SP), SPEC, m,
                                    connectivity=connectivity)
    lt, lj = out[0].numpy(), np.asarray(ref[0])
    assert (lt == lj).mean() >= 0.999
    same = _same_superpixels(lt, lj, cfg.n_segments)
    assert same.mean() >= 0.9
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_features_core_matches_jax(shape):
    _check_slic_features_core(shape, connectivity=False)


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_features_core_connectivity_matches_jax(shape):
    """Enforced labels, min-size merge and the moments re-reduce."""
    _check_slic_features_core(shape, connectivity=True)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('seed', [3, 4])
def test_segment_slice_matches_jax(models, shape, seed):
    jm, tm = models
    img = _image(shape, seed)
    dj, dt = {}, {}
    segm_j, soft_j = jpipe.segment_color2d_slic_features_model_graphcut(
        img, jm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj, connectivity=False)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        img, tm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dt, connectivity=False)
    assert segm_t.shape == shape and segm_t.dtype == np.int32
    assert soft_t.shape == shape + (3,) and np.isfinite(soft_t).all()
    assert (dt['slic'] == dj['slic']).mean() >= 0.999
    k = jslic.slic_config(*shape, SP).n_segments
    same = _same_superpixels(dt['slic'], dj['slic'], k)
    np.testing.assert_allclose(dt['proba'][same], dj['proba'][same],
                               rtol=1e-5, atol=1e-5)
    assert adjusted_rand_score(segm_t, np.asarray(segm_j)) >= 0.98
    px = (dt['slic'] == dj['slic']) & same[dj['slic']]
    np.testing.assert_allclose(soft_t[px], np.asarray(soft_j)[px], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('seed', [3, 4])
def test_segment_default_connectivity_matches_jax(models, shape, seed):
    """The default ``connectivity=True``: ARS >= 0.98 against the JAX call,
    enforced labels >= 0.999 equal."""
    jm, tm = models
    img = _image(shape, seed)
    dj, dt = {}, {}
    segm_j, soft_j = jpipe.segment_color2d_slic_features_model_graphcut(
        img, jm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        img, tm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dt)
    assert segm_t.shape == shape and segm_t.dtype == np.int32
    assert soft_t.shape == shape + (3,) and np.isfinite(soft_t).all()
    assert (dt['slic'] == dj['slic']).mean() >= 0.999
    assert adjusted_rand_score(segm_t, np.asarray(segm_j)) >= 0.98
    k = jslic.slic_config(*shape, SP).n_segments
    same = _same_superpixels(dt['slic'], dj['slic'], k)
    px = (dt['slic'] == dj['slic']) & same[dj['slic']]
    np.testing.assert_allclose(soft_t[px], np.asarray(soft_j)[px], rtol=1e-5,
                               atol=1e-5)


def test_bench_geometry_matches_committed_jax_output():
    """Image 0 at 884x1200 against the JAX-CPU segmentation stored in the
    fixture that chip_smoke.py checks the card against."""
    with np.load(os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture.npz')) as npz:
        fixture = {k: npz[k] for k in npz.files}
    img = _image((884, 1200), 0)
    debug = {}
    segm, _ = tpipe.segment_color2d_slic_features_model_graphcut(
        img, class_model_from_numpy(fixture), FEATURES, sp_size=35,
        sp_regul=0.2, gc_regul=2.0, debug_visual=debug, connectivity=False)
    assert (debug['slic'] == fixture['slic']).mean() >= 0.999
    assert adjusted_rand_score(segm, fixture['segm']) >= 0.98


def test_bench_geometry_connectivity_matches_committed_jax_output():
    """Image 0 at 884x1200 at the default ``connectivity=True`` against the
    JAX-CPU result that chip_smoke.py checks the card against."""
    data = os.path.join(ROOT, 'tests', 'data')
    with np.load(os.path.join(data, 'torch_port_fixture.npz')) as npz:
        model = class_model_from_numpy({k: npz[k] for k in npz.files})
    with np.load(os.path.join(data, 'torch_port_fixture_conn.npz')) as npz:
        want = {k: npz[k] for k in npz.files}
    debug = {}
    segm, _ = tpipe.segment_color2d_slic_features_model_graphcut(
        _image((884, 1200), 0), model, FEATURES, sp_size=35, sp_regul=0.2,
        gc_regul=2.0, debug_visual=debug)
    assert (debug['slic'] == want['slic']).mean() >= 0.999
    assert adjusted_rand_score(segm, want['segm']) >= 0.98


# texture keys of colour images are ported (tests/test_torch_supervised.py);
# those of gray images too: their cases hold the port to JAX
@pytest.mark.parametrize('kwargs', [
    {'gray': True, 'dict_features': {'color': ['mean'], 'tLM': ['mean']}},
    {'connectivity': False, 'sp_compat': True},
    {'gray': True, 'connectivity': False,
     'dict_features': {'tLM_short': ['mean']}},
    {'gray': True,
     'dict_features': {'color_hsv': ['mean'], 'tGabor': ['mean']}},
], ids=['texture', 'sp_compat', 'texture_short', 'gabor'])
def test_unported_options_raise(kwargs):
    """Options that once raised.  ``sp_compat`` (formerly a raise)
    segments as JAX's does with a class model the JAX package fits on the
    image, carried across: ARS >= 0.98.  A gray image with LM texture
    (formerly a raise) segments as JAX's does with a GMM the JAX package
    fits on its features, carried across: SLIC labels >= 0.999 equal, ARS
    >= 0.98.  Gray Gabor beside a colour key over the grid reduce raises
    ValueError in both packages (the reference takes the non-colour keys
    as a volume, which has no Gabor)."""
    kwargs = dict(kwargs)
    feats = kwargs.pop('dict_features', FEATURES)
    img = _image(SHAPES[0], 0)
    if not kwargs.pop('gray', False):
        jm, _ = jpipe.estim_model_classes_group([img], 3, feats, sp_size=SP,
                                                sp_regul=REGUL)
        tm = class_model_from_numpy({k: np.asarray(v) for k, v in {
            'weights': jm.gmm.weights, 'means': jm.gmm.means,
            'covs': jm.gmm.covs, 'scaler_mean': jm.scaler_mean,
            'scaler_scale': jm.scaler_scale}.items()})
        segm_j, _ = jpipe.segment_color2d_slic_features_model_graphcut(
            img, jm, feats, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
            **kwargs)
        segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
            img, tm, feats, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
            **kwargs)
        assert np.isfinite(soft_t).all()
        assert adjusted_rand_score(segm_t, np.asarray(segm_j)) >= 0.98
        return
    img = np.ascontiguousarray(img[..., 0])
    conn = kwargs.get('connectivity', True)
    cfg = jslic.slic_config(*SHAPES[0], SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    spec = jpipe._features_spec(feats)
    if 'tGabor' in feats:
        for call in (lambda: jpipe._slic_features_core(
                jnp.asarray(img), cfg, spec, m, connectivity=conn),
                lambda: tpipe.segment_color2d_slic_features_model_graphcut(
                    img, class_model_from_numpy({
                        'weights': np.ones(1), 'means': np.zeros((1, 1)),
                        'covs': np.eye(1)[None]}), feats, sp_size=SP,
                    **kwargs)):
            with pytest.raises(ValueError):
                call()
        return
    _, f, counts, _ = jpipe._slic_features_core(jnp.asarray(img), cfg, spec,
                                                m, connectivity=conn)
    jm = estim_class_model(f, 3, 'GMM',
                           sample_weight=(counts > 0).astype(jnp.float32))
    tm = class_model_from_numpy({k: np.asarray(v) for k, v in {
        'weights': jm.gmm.weights, 'means': jm.gmm.means,
        'covs': jm.gmm.covs, 'scaler_mean': jm.scaler_mean,
        'scaler_scale': jm.scaler_scale}.items()})
    dj, dt = {}, {}
    segm_j, _ = jpipe.segment_color2d_slic_features_model_graphcut(
        img, jm, feats, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj, **kwargs)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        torch.as_tensor(img), tm, feats, sp_size=SP, sp_regul=REGUL,
        gc_regul=GC, debug_visual=dt, **kwargs)
    assert np.isfinite(soft_t).all()
    assert (dt['slic'] == np.asarray(dj['slic'])).mean() >= 0.999
    ars = adjusted_rand_score(segm_t, np.asarray(segm_j))
    print('gray %s: ARS %.6f against JAX' % (list(feats), ars))
    assert ars >= 0.98


def test_numpy_input_needs_a_card_or_device_cpu():
    """A numpy image runs on ``device``, 'cuda' by default: without a card
    the call raises instead of running on the CPU."""
    img = _image(SHAPES[0], 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpipe.compute_color2d_superpixels_features(img, FEATURES_ALL,
                                                       sp_size=SP)
    labels, feats = tpipe.compute_color2d_superpixels_features(
        img, FEATURES_ALL, sp_size=SP, device='cpu')
    assert labels.shape == SHAPES[0] and feats.shape[1] == 15


@pytest.mark.parametrize('spec', [FEATURES_ALL, {'color_hsv': ['mean', 'std']},
                                  {'color_lab': ['median'],
                                   'color': ['meanGrad']}],
                         ids=['all_flags', 'fused_hsv', 'lab_and_rgb'])
@pytest.mark.parametrize('connectivity', [True, False])
def test_slic_features_core_any_spec_matches_jax(spec, connectivity):
    """Every 2D branch of the core: the fused branch with a colour-space
    key, and the labels-only SLIC + descriptors for the other specs."""
    img = _image(SHAPES[1], 5)
    cfg = jslic.slic_config(*SHAPES[1], SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    fspec = jpipe._features_spec(spec)
    ref = jpipe._slic_features_core(jnp.asarray(img), cfg, fspec, m,
                                    connectivity=connectivity)
    out = tpipe._slic_features_core(torch.as_tensor(img),
                                    tslic.slic_config(*SHAPES[1], SP), fspec,
                                    m, connectivity=connectivity)
    lt, lj = out[0].numpy(), np.asarray(ref[0])
    assert (lt == lj).mean() >= 0.999
    same = _same_superpixels(lt, lj, cfg.n_segments)
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('connectivity', [True, False])
def test_slico_features_core_matches_jax(connectivity):
    img = _image(SHAPES[0], 6)
    cfg = jslic.slic_config(*SHAPES[0], SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    fspec = jpipe._features_spec(FEATURES)
    ref = jpipe._slic_features_core(jnp.asarray(img), cfg, fspec, m,
                                    slico=True, connectivity=connectivity)
    out = tpipe._slic_features_core(torch.as_tensor(img),
                                    tslic.slic_config(*SHAPES[0], SP), fspec,
                                    m, slico=True, connectivity=connectivity)
    assert (out[0].numpy() == np.asarray(ref[0])).mean() >= 0.999
    same = _same_superpixels(out[0].numpy(), np.asarray(ref[0]),
                             cfg.n_segments)
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('seed', [3, 4])
def test_pipe_unsupervised_matches_jax(seed):
    """The flagship unsupervised call: features + a GMM fitted on the image
    + MRF.  The fits draw other random numbers, so they are held by the
    weighted log-likelihood on the same features and by the segmentation's
    ARS."""
    img = _image(SHAPES[0], seed)
    dj, dt = {}, {}
    segm_j, _ = jpipe.pipe_color2d_slic_features_model_graphcut(
        img, 3, FEATURES_ALL, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj)
    segm_t, soft_t = tpipe.pipe_color2d_slic_features_model_graphcut(
        img, 3, FEATURES_ALL, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dt, device='cpu')
    assert segm_t.shape == SHAPES[0] and np.isfinite(soft_t).all()
    assert (dt['slic'] == dj['slic']).mean() >= 0.999
    same = _same_superpixels(dt['slic'], dj['slic'], dj['features'].shape[0])
    np.testing.assert_allclose(dt['features'][same],
                               np.asarray(dj['features'])[same], rtol=1e-5,
                               atol=1e-4)
    assert adjusted_rand_score(segm_t, np.asarray(segm_j)) >= 0.98
    x = torch.as_tensor(np.array(dj['features']))
    w = torch.as_tensor(np.bincount(dj['slic'].ravel(),
                                    minlength=x.shape[0]) > 0).float()
    jm = class_model_from_numpy({
        'weights': dj['model'].gmm.weights, 'means': dj['model'].gmm.means,
        'covs': dj['model'].gmm.covs, 'scaler_mean': dj['model'].scaler_mean,
        'scaler_scale': dj['model'].scaler_scale})
    tm = dt['model']
    sj = float(tgmm.gmm_score(jm.gmm, jm.transform(x), w))
    st = float(tgmm.gmm_score(tm.gmm, tm.transform(x), w))
    assert abs(st - sj) <= 1e-3 * abs(sj)


def test_fit_group_then_segment_matches_jax():
    """``estim_model_classes_group`` on two images, then the single-image
    and the batch calls with the port-fitted model, against the JAX fit.
    Six features: at 15 on ~100 superpixels the full-covariance fit has
    several optima, and the two generators' restarts may settle in
    different ones."""
    imgs = [_image(SHAPES[0], s) for s in (7, 8)]
    spec = {'color': ['mean', 'median']}
    jm, fj = jpipe.estim_model_classes_group(imgs, 3, spec,
                                             sp_size=SP, sp_regul=REGUL)
    tm, ft = tpipe.estim_model_classes_group(imgs, 3, spec,
                                             sp_size=SP, sp_regul=REGUL,
                                             device='cpu')
    for img, a, b in zip(imgs, ft, fj):
        lj, _ = jpipe.compute_color2d_superpixels_features(
            img, spec, sp_size=SP, sp_regul=REGUL)
        lt, _ = tpipe.compute_color2d_superpixels_features(
            img, spec, sp_size=SP, sp_regul=REGUL, device='cpu')
        assert (lt == lj).mean() >= 0.999
        same = _same_superpixels(lt, lj, b.shape[0])
        np.testing.assert_allclose(a[same], np.asarray(b)[same], rtol=1e-5,
                                   atol=1e-4)
    x = torch.as_tensor(np.concatenate([np.array(f) for f in fj]))
    w = (x.abs().sum(-1) > 0).float()
    sj = float(jm_score(jm, x, w))
    st = float(tgmm.gmm_score(tm.gmm, tm.transform(x), w))
    assert abs(st - sj) <= 1e-3 * abs(sj)
    yj = np.asarray(jm.predict(jnp.asarray(x.numpy())))
    yt = tm.predict(x).numpy()
    keep = w.numpy() > 0
    assert adjusted_rand_score(yt[keep], yj[keep]) >= 0.98
    img = _image(SHAPES[0], 9)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        img, tm, spec, sp_size=SP, sp_regul=REGUL, gc_regul=GC)
    assert segm_t.shape == SHAPES[0] and np.isfinite(soft_t).all()
    segms, _ = tbatch.segment_images_batch(np.stack([img, imgs[0]]), tm,
                                           spec, sp_size=SP,
                                           sp_regul=REGUL, gc_regul=GC)
    np.testing.assert_array_equal(segms[0], segm_t)


def jm_score(jm, x, w):
    """The JAX fit's weighted mean log-likelihood, computed by the port
    from the carried-over arrays."""
    arrays = {'weights': jm.gmm.weights, 'means': jm.gmm.means,
              'covs': jm.gmm.covs, 'scaler_mean': jm.scaler_mean,
              'scaler_scale': jm.scaler_scale}
    cm = class_model_from_numpy({k: np.asarray(v) for k, v in arrays.items()})
    return tgmm.gmm_score(cm.gmm, cm.transform(x), w)


def test_compute_superpixel_features_matches_jax():
    img = _image(SHAPES[1], 10)
    lj, fj = jpipe.compute_color2d_superpixels_features(
        img, FEATURES_ALL, sp_size=SP, sp_regul=REGUL)
    lt, ft = tpipe.compute_color2d_superpixels_features(
        img, FEATURES_ALL, sp_size=SP, sp_regul=REGUL, device='cpu')
    assert lt.dtype == np.int32 and (lt == lj).mean() >= 0.999
    same = _same_superpixels(lt, lj, fj.shape[0])
    np.testing.assert_allclose(ft[same], fj[same], rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        tpipe.compute_color2d_superpixels_features(img, FEATURES_ALL,
                                                   sp_regul=0, device='cpu')


@pytest.mark.parametrize('slico', [False, True], ids=['slic', 'slico'])
def test_segment_slic_img2d_matches_jax(slico):
    img = _image(SHAPES[1], 11)
    lj = np.asarray(jsp.segment_slic_img2d(img, sp_size=SP,
                                           relative_compact=REGUL,
                                           slico=slico))
    lt = tsp.segment_slic_img2d(img, sp_size=SP, relative_compact=REGUL,
                                slico=slico, device='cpu')
    assert lt.dtype == np.int32 and lt.shape == SHAPES[1]
    assert (lt == lj).mean() >= 0.999
    with pytest.raises(ValueError):
        tsp.segment_slic_img2d(img, compat=True, slico=True, device='cpu')
    np.testing.assert_array_equal(
        tsp.make_graph_segm_connect_grid2d_conn4(lt)[1],
        jsp.make_graph_segm_connect_grid2d_conn4(lt)[1])
    vol = np.stack([lt, lt[::-1]])
    np.testing.assert_array_equal(
        tsp.make_graph_segm_connect_grid3d_conn6(vol)[1],
        jsp.make_graph_segm_connect_grid3d_conn6(vol)[1])


def test_color_edge_weights_match_jax(models):
    """``gc_edge_type='color'`` (its mean colours go through the grid
    reduce, which the card now runs)."""
    jm, tm = models
    img = _image(SHAPES[0], 12)
    segm_j, _ = jpipe.segment_color2d_slic_features_model_graphcut(
        img, jm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        gc_edge_type='color')
    segm_t, _ = tpipe.segment_color2d_slic_features_model_graphcut(
        img, tm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        gc_edge_type='color')
    assert adjusted_rand_score(segm_t, np.asarray(segm_j)) >= 0.98


class _DuckModel:
    """An sklearn-style model: numpy ``predict_proba`` (here the JAX GMM's)
    and ``classes_``."""

    def __init__(self, model):
        self.model = model
        self.classes_ = np.array([3, 5, 7])

    def predict_proba(self, x):
        return np.asarray(self.model.predict_proba(jnp.asarray(x)))


def test_classifier_raises(models):
    """A model that is neither a ClassModel nor a Classifier (formerly a
    raise) takes the reference's generic route: the same duck-typed model
    in both packages gives SLIC labels >= 0.999 equal, the proba of the
    unchanged superpixels within 1e-5 and a segmentation with ARS >= 0.98,
    relabelled by ``classes_``; an object without ``predict_proba`` raises
    AttributeError, as in JAX."""
    jm, _ = models
    duck = _DuckModel(jm)
    img = _image(SHAPES[1], 4)
    dj, dt = {}, {}
    segm_j, soft_j = jpipe.segment_color2d_slic_features_model_graphcut(
        img, duck, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dj)
    segm_t, soft_t = tpipe.segment_color2d_slic_features_model_graphcut(
        img, duck, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        debug_visual=dt, device='cpu')
    assert segm_t.shape == SHAPES[1] and soft_t.shape == SHAPES[1] + (3,)
    assert set(np.unique(segm_t)) <= {3, 5, 7}
    assert (dt['slic'] == np.asarray(dj['slic'])).mean() >= 0.999
    same = _same_superpixels(dt['slic'], np.asarray(dj['slic']),
                             len(dt['proba']))
    np.testing.assert_allclose(dt['proba'][same], dj['proba'][same],
                               atol=1e-5)
    ars = adjusted_rand_score(segm_t, segm_j)
    print('duck-typed model: ARS %.6f against JAX' % ars)
    assert ars >= 0.98
    for pipe, kw in ((jpipe, {}), (tpipe, {'device': 'cpu'})):
        with pytest.raises(AttributeError):
            pipe.segment_color2d_slic_features_model_graphcut(
                img, object(), FEATURES, **kw)


def test_wrapper_slic_features_labels_matches_jax():
    """SLIC, features and the superpixels' annotation labels of one image:
    labels >= 0.999 equal, features of the unchanged superpixels within
    rtol 1e-5 + 1e-5, superpixel labels equal on them."""
    img, annot = sample_color_image_rand_segment(SHAPES[0], 3, rand_seed=5)
    annot = annot.copy()
    annot[:4, :6] = -1
    slic_j, feats_j, lbs_j = \
        jpipe.wrapper_compute_color2d_slic_features_labels(
            (img, annot), SP, REGUL, FEATURES)
    slic_t, feats_t, lbs_t = \
        tpipe.wrapper_compute_color2d_slic_features_labels(
            (img, annot), SP, REGUL, FEATURES, device='cpu')
    assert (slic_t == np.asarray(slic_j)).mean() >= 0.999
    same = _same_superpixels(slic_t, np.asarray(slic_j), len(lbs_t))
    np.testing.assert_allclose(feats_t[same], feats_j[same], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(lbs_t[same], lbs_j[same])
    assert (lbs_t == -1).any()


_IMPORT_CHECK = """
import sys
sys.modules['jax'] = None
sys.modules['pyimsegm_tpu'] = None
sys.modules['PIL'] = None
import pyimsegm_tpu_torch
from pyimsegm_tpu_torch import (_build, annotation, centers, classification,
                                descriptors, ellipse_fitting, graph_cuts,
                                labeling, pipelines, region_growing,
                                superpixels)
from pyimsegm_tpu_torch.models import (adaboost, bgm, class_model,
                                       clustering, forest, gbt, gmm, linear,
                                       otsu)
from pyimsegm_tpu_torch.ops import (color, connectivity_cuda,
                                    connectivity_host, enforce_cuda, filters,
                                    graph, graphcut, grid, grid_cuda,
                                    histogram, morphology, prep_cuda, ray,
                                    segment_stats, shape_prior, slic, slic3d,
                                    slic3d_cuda, slic_cuda, snakes)
from pyimsegm_tpu_torch.parallel import batch
from pyimsegm_tpu_torch.utils import (ImageDimensionError, data_io,
                                      data_samples, device, metrics, nifti,
                                      profiling, read_zvi)
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
bad = [m for m in sys.modules if m.startswith(('jax', 'pyimsegm_tpu.'))
       and sys.modules[m] is not None]
assert not bad, bad
print('ok')
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, '-c', _IMPORT_CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Without a CUDA card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    runs = [([sys.executable, os.path.join(ROOT, 'chip_smoke.py')], ROOT)]
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text(open(os.path.join(ROOT, 'chip_smoke.py')).read())
    runs.append(([sys.executable, str(alone)], str(tmp_path)))
    for cmd, cwd in runs:
        proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                              timeout=120, env=dict(os.environ,
                                                    CUDA_VISIBLE_DEVICES=''))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
