"""The ported slice end to end vs the JAX package on the CPU:
``segment_color2d_slic_features_model_graphcut`` with ``connectivity=False``
and at its default ``connectivity=True``, with one fitted GMM class model
handed to both packages."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import pipelines as jpipe
from pyimsegm_tpu.models.class_model import estim_class_model
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP, REGUL, GC = 16, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
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


@pytest.mark.parametrize('kwargs', [
    {'connectivity': True, 'dict_features': {'color': ['mean', 'median']}},
    {'connectivity': False, 'sp_compat': True},
    {'connectivity': False, 'dict_features': {'color': ['mean', 'median']}},
    {'connectivity': False, 'dict_features': {'color_hsv': ['mean']}},
], ids=['connectivity', 'sp_compat', 'median', 'colour_space'])
def test_unported_options_raise(models, kwargs):
    _, tm = models
    kwargs = dict(kwargs)
    feats = kwargs.pop('dict_features', FEATURES)
    with pytest.raises(NotImplementedError):
        tpipe.segment_color2d_slic_features_model_graphcut(
            _image(SHAPES[0], 0), tm, feats, sp_size=SP, **kwargs)


def test_classifier_raises():
    with pytest.raises(NotImplementedError):
        tpipe.segment_color2d_slic_features_model_graphcut(
            _image(SHAPES[0], 0), object(), FEATURES, connectivity=False)


_IMPORT_CHECK = """
import sys
sys.modules['jax'] = None
sys.modules['pyimsegm_tpu'] = None
import pyimsegm_tpu_torch
from pyimsegm_tpu_torch import _build, pipelines
from pyimsegm_tpu_torch.models import class_model, gmm
from pyimsegm_tpu_torch.ops import (enforce_cuda, graphcut, grid, grid_cuda,
                                    prep_cuda, slic, slic_cuda)
from pyimsegm_tpu_torch.parallel import batch
from pyimsegm_tpu_torch.utils import data_samples, metrics
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
