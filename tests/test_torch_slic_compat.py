"""The port's skimage-compat SLIC (``ops/slic._slic_segment_skimage``,
``segment_slic_img2d(compat=True)``), its host connectivity postprocess
(``ops/connectivity_host.py``) and the ``sp_compat`` pipeline vs the JAX
package on the CPU, then the committed 647x1024 fixture.

Bars: raw labels equal on >= 0.999 of the pixels (the centres are f32
sums in another order); the union-find copy exact on JAX's raw labels
(against the JAX package's native library and its numpy twin); every
output label one conn4 component, numbered sequentially; the
``sp_compat`` segmentation ARS >= 0.98 against JAX's."""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import native
from pyimsegm_tpu import pipelines as jpipe
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
from pyimsegm_tpu_torch.ops import connectivity_host
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils.data_samples import (
    sample_color_image_rand_segment, sample_ovary_scene)
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
from make_torch_port_fixture import (FEATURES, GC_REGUL,  # noqa: E402
                                     OUT_RG2SP, OVARY, RG_REGUL, RG_SP,
                                     RG_TEST_SEED, _model_arrays)

RAW_BAR, ARS_BAR = 0.999, 0.98
CASES = {'ovary': (lambda: sample_ovary_scene((120, 200), 2,
                                              rand_seed=5)[0], 12, 0.2),
         'segments': (lambda: sample_color_image_rand_segment(
             (96, 150), 3, rand_seed=2)[0], 9, 0.3)}


@functools.lru_cache(maxsize=None)
def _raw(case):
    make, sp, regul = CASES[case]
    img = make()
    h, w = img.shape[:2]
    m = jslic.compactness_from_regul(sp, regul)
    want = np.asarray(jslic._slic_segment_xla_skimage(
        jnp.asarray(img), jslic.slic_config(h, w, sp), m))
    got = tslic._slic_segment_skimage(torch.as_tensor(img),
                                      tslic.slic_config(h, w, sp), m)
    return img, sp, regul, want, got


def _connected_and_sequential(labels):
    from scipy import ndimage
    uq = np.unique(labels)
    np.testing.assert_array_equal(uq, np.arange(len(uq)))
    for lb in uq:
        assert ndimage.label(labels == lb)[1] == 1


@pytest.mark.parametrize('case', list(CASES))
def test_compat_slic_raw_matches_jax(case):
    img, sp, _, want, got = _raw(case)
    assert got.dtype == torch.int32 and got.shape == img.shape[:2]
    assert (got.numpy() == want).mean() >= RAW_BAR


@pytest.mark.parametrize('case', list(CASES))
def test_enforce_copy_exact(case):
    """On JAX's raw labels, with the compat mode's size floor and with a
    larger one that merges many fragments."""
    _, sp, _, want, _ = _raw(case)
    raw = want.astype(np.int32)
    for min_size in (int(0.5 * sp * sp), 2 * sp * sp):
        got = connectivity_host.enforce_connectivity(raw, min_size)
        np.testing.assert_array_equal(got, native.enforce_connectivity(
            raw, min_size))
        np.testing.assert_array_equal(
            got, native._enforce_connectivity_numpy(raw, min_size))
        _connected_and_sequential(got)


def test_segment_slic_img2d_compat_contract():
    img = CASES['ovary'][0]()
    got = tslic.segment_slic_img2d(img, sp_size=12, relative_compact=0.2,
                                   compat=True, device='cpu')
    want = np.asarray(jslic.segment_slic_img2d(img, sp_size=12,
                                               relative_compact=0.2,
                                               compat=True))
    assert got.dtype == np.int32 and got.shape == img.shape[:2]
    _connected_and_sequential(got)
    assert adjusted_rand_score(got, want) >= ARS_BAR
    raw = tslic.segment_slic_img2d(img, sp_size=12, relative_compact=0.2,
                                   compat=True, enforce_connectivity=False,
                                   device='cpu')
    assert raw.max() < tslic.slic_config(*img.shape[:2], 12).n_segments
    with pytest.raises(ValueError):
        tslic.segment_slic_img2d(img, compat=True, slico=True, device='cpu')


def test_sp_compat_pipeline_matches_jax():
    """``sp_compat=True`` with a class model JAX fits on the image, carried
    across."""
    img = CASES['segments'][0]()
    model, _ = jpipe.estim_model_classes_group([img], 3, FEATURES,
                                               sp_size=9, sp_regul=0.3)
    want, want_soft = jpipe.segment_color2d_slic_features_model_graphcut(
        img, model, FEATURES, sp_size=9, sp_regul=0.3, gc_regul=GC_REGUL,
        sp_compat=True)
    got, soft = tpipe.segment_color2d_slic_features_model_graphcut(
        img, class_model_from_numpy(_model_arrays(model)), FEATURES,
        sp_size=9, sp_regul=0.3, gc_regul=GC_REGUL, sp_compat=True,
        device='cpu')
    assert got.shape == img.shape[:2] and soft.shape == want_soft.shape
    assert np.isfinite(soft).all()
    assert adjusted_rand_score(got, np.asarray(want)) >= ARS_BAR


@pytest.fixture(scope='module')
def fixture():
    with np.load(OUT_RG2SP) as npz:
        return {k: npz[k] for k in npz.files}


def test_fixture_compat_enforce(fixture):
    """The fixture's 647x1024 raw compat labels through the port's copy
    give JAX's enforced labels exactly."""
    raw = fixture['compat_raw'].astype(np.int32)
    cfg = tslic.slic_config(*OVARY, RG_SP)
    got = connectivity_host.enforce_connectivity(
        raw, min_size=int(0.5 * cfg.step * cfg.step))
    np.testing.assert_array_equal(got, fixture['compat_enforced'])
    assert tslic.compactness_from_regul(RG_SP, RG_REGUL) > 0
    assert sample_ovary_scene(OVARY, 4, rand_seed=RG_TEST_SEED)[0].shape \
        == OVARY + (3,)
