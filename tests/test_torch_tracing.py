"""The port's tracing system (``utils.device``): the ``pyimsegm:<stage>``
ranges of the segmentation entries, the ``pyimsegm:gather`` range of their
host gather, and the EM counters of the GMM fit; all of it lives only
while a ``torch.profiler`` session records, and changes no result."""

import collections
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from pyimsegm_tpu_torch import pipelines
from pyimsegm_tpu_torch.classification import Classifier
from pyimsegm_tpu_torch.models import gmm
from pyimsegm_tpu_torch.models.class_model import estim_class_model
from pyimsegm_tpu_torch.utils import device as dv
from pyimsegm_tpu_torch.utils.data_samples import (
    sample_color_image_rand_segment, sample_gray_volume_3d)

from torch_threads import one_torch_thread  # noqa: F401

SHAPE, SP = (64, 80), 16
FEATURES = {'color': ['mean', 'std', 'energy']}
#: the classes a trained classifier relabels its segmentation to
CLASSES = (3, 5, 7)


def _image(seed=0):
    return sample_color_image_rand_segment(SHAPE, 3, rand_seed=seed)[0]


@pytest.fixture(scope='module')
def models():
    """A decision tree trained on the superpixels of one image, labelled by
    their brightness tercile into ``CLASSES``, and a GMM fitted on them."""
    _, feats = pipelines.compute_color2d_superpixels_features(
        _image(1), FEATURES, sp_size=SP, device='cpu')
    bright = feats[:, :3].mean(1)
    y = np.asarray(CLASSES)[np.digitize(
        bright, np.quantile(bright, [1 / 3, 2 / 3]))]
    clf = Classifier('DecTree', device='cpu').fit(feats, y)
    model = estim_class_model(torch.as_tensor(feats), 3, 'GMM', seed=0)
    return clf, model


def _calls(models):
    clf, model = models
    img = _image(2)
    vol = sample_gray_volume_3d((8, 40, 48), rand_seed=0)[0]
    seg = pipelines.segment_color2d_slic_features_model_graphcut
    return {
        'classifier': lambda: seg(img, clf, FEATURES, sp_size=SP),
        'classifier_raw': lambda: seg(img, clf, FEATURES, sp_size=SP,
                                      connectivity=False),
        'classifier_debug': lambda: seg(img, clf, FEATURES, sp_size=SP,
                                        debug_visual={}),
        'class_model': lambda: seg(img, model, FEATURES, sp_size=SP),
        'class_model_raw': lambda: seg(img, model, FEATURES, sp_size=SP,
                                       connectivity=False),
        'compat': lambda: seg(img, model, FEATURES, sp_size=SP,
                              sp_compat=True),
        'pipe_color2d': lambda: pipelines.
        pipe_color2d_slic_features_model_graphcut(
            img, 3, FEATURES, sp_size=SP, device='cpu'),
        'pipe_color2d_debug': lambda: pipelines.
        pipe_color2d_slic_features_model_graphcut(
            img, 3, FEATURES, sp_size=SP, debug_visual={}, device='cpu'),
        'pipe_gray3d': lambda: pipelines.
        pipe_gray3d_slic_features_model_graphcut(
            vol, 2, FEATURES, spacing=(2, 1, 1), sp_size=8, device='cpu'),
    }


CASES = ('classifier', 'classifier_raw', 'classifier_debug', 'class_model',
         'class_model_raw', 'compat', 'pipe_color2d', 'pipe_color2d_debug',
         'pipe_gray3d')
#: the stage ranges each entry opens once a call (the compat route keeps
#: its own SLIC, features and classify stages; only raw labels take the
#: device ``lookup``)
STAGES = {
    'classifier': {'upload', 'slic', 'enforce', 'features', 'predict_proba',
                   'edges', 'mrf', 'fetch', 'gather'},
    'class_model': {'upload', 'slic', 'enforce', 'features', 'predict_proba',
                    'edges', 'mrf', 'fetch', 'gather'},
    'compat': {'upload', 'slic', 'features', 'classify', 'edges', 'mrf',
               'fetch', 'gather'},
    'pipe_color2d': {'upload', 'slic', 'enforce', 'features', 'fit',
                     'predict_proba', 'edges', 'mrf', 'fetch', 'gather'},
    'pipe_gray3d': {'upload', 'slic', 'counts', 'features', 'fit',
                    'predict_proba', 'edges', 'mrf', 'lookup', 'fetch',
                    'gather'},
}
STAGES['classifier_debug'] = STAGES['classifier']
STAGES['classifier_raw'] = STAGES['classifier'] - {'enforce'} | {'lookup'}
STAGES['class_model_raw'] = STAGES['class_model'] - {'enforce'} | {'lookup'}
STAGES['pipe_color2d_debug'] = STAGES['pipe_color2d']


def _stage_ranges(prof, folder):
    """[(start, end, stage)] of the ``pyimsegm:`` ranges in a profile's
    chrome trace."""
    path = os.path.join(folder, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    os.remove(path)
    return [(ev['ts'], ev['ts'] + ev['dur'],
             ev['name'][len(dv.STAGE_PREFIX):]) for ev in events
            if ev.get('cat') == 'user_annotation'
            and ev['name'].startswith(dv.STAGE_PREFIX)]


@pytest.fixture(scope='module')
def runs(models, tmp_path_factory):
    """Each case once untraced and once traced: {case: (untraced result,
    traced result, ranges)}."""
    folder = str(tmp_path_factory.mktemp('traces'))
    out = {}
    for case, fn in _calls(models).items():
        off = fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = fn()
        out[case] = (off, on, _stage_ranges(prof, folder))
    return out


@pytest.mark.parametrize('case', CASES)
def test_gather_once_per_call_inside_fetch(runs, case):
    """Every entry's host gather is one ``pyimsegm:gather`` range inside
    its one ``pyimsegm:fetch``."""
    _, _, ranges = runs[case]
    fetch = [r for r in ranges if r[2] == 'fetch']
    gather = [r for r in ranges if r[2] == 'gather']
    assert len(fetch) == 1 and len(gather) == 1
    assert fetch[0][0] <= gather[0][0] and gather[0][1] <= fetch[0][1]


@pytest.mark.parametrize('case', CASES)
def test_stage_names_once_and_never_inside_themselves(runs, case):
    """The same stage names on every path, each opened once a call, and no
    stage range opens inside a range of its own name."""
    _, _, ranges = runs[case]
    names = collections.Counter(name for *_, name in ranges)
    assert set(names) == STAGES[case]
    assert all(n == 1 for n in names.values()), names
    for i, (s, e, name) in enumerate(ranges):
        for j, (s2, e2, name2) in enumerate(ranges):
            if i != j and name2 == name:
                assert e <= s2 or e2 <= s, name


@pytest.mark.parametrize('case', CASES)
def test_results_equal_with_tracing_on_and_off(runs, case):
    off, on, _ = runs[case]
    off, on = (off,) if isinstance(off, np.ndarray) else off, \
        (on,) if isinstance(on, np.ndarray) else on
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_classifier_relabels_inside_gather(runs):
    """The trained classifier's ``classes_`` relabel the segmentation."""
    segm, _ = runs['classifier'][0]
    assert set(np.unique(segm)) <= set(CLASSES)


# --------------------------------------------------------------- counters --

def _blobs(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.cat([torch.randn(n // 2, 2, generator=g),
                   torch.randn(n // 2, 2, generator=g) + 8.0])
    return x, torch.ones(n)


def _collinear(n=600, d=23, rank=3, seed=0, scale=30.0):
    """Rank-3 features in 23 columns whose float32 covariances break down
    (``tests/test_torch_fit.py``'s case of the float64 refit)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    lat = rng.normal(size=(n, rank)) + 4.0 * y[:, None]
    x = scale * (lat @ rng.normal(size=(rank, d)))
    return torch.as_tensor(x.astype(np.float32)), torch.ones(n)


def _fit(x, w, n_init=9):
    return gmm.gmm_fit(torch.Generator().manual_seed(0), x, w, 2,
                       n_init=n_init)


def test_counters_move_only_inside_a_profiler_session():
    x, w = _blobs()
    dv.reset_counters()
    assert not dv.tracing()
    dv.count('em_runs')
    _fit(x, w)
    assert dv.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert dv.tracing()
        _fit(x, w)
    got = dv.counters()
    assert got['em_runs'] == 1 and got['em_iters'] == 99
    assert got['em_restart_iters'] == 9 * 99
    assert 0 < got['em_active_iters'] <= got['em_restart_iters']
    assert 'em_refits' not in got
    _fit(x, w)
    assert dv.counters() == got
    got['em_runs'] = 0                      # a copy
    assert dv.counters()['em_runs'] == 1
    dv.reset_counters()
    assert dv.counters() == {}


def test_separated_data_converge_before_the_last_iteration():
    x, w = _blobs()
    dv.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _fit(x, w)
    got = dv.counters()
    dv.reset_counters()
    assert got['em_active_iters'] < got['em_restart_iters']


def test_collinear_features_count_one_refit():
    x, w = _collinear()
    dv.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        params = _fit(x, w)
    got = dv.counters()
    dv.reset_counters()
    assert params.covs.dtype == torch.float64
    assert got['em_refits'] == 1 and got['em_runs'] == 2
    assert got['em_iters'] == 2 * 99
    assert got['em_restart_iters'] == 2 * 9 * 99
    assert 0 < got['em_active_iters'] <= got['em_restart_iters']


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('max_iter', [1, 17])
def test_em_fit_untraced_runs_the_traced_ops_less_the_counters(max_iter):
    """Untraced, EM runs exactly the traced run's aten ops less the
    counters' (one buffer, one add an iteration it ran, each iteration's
    one softmax; the loop ends once every restart has stopped): no op and
    no host copy of its own."""
    x, w = _blobs()
    labels = gmm.kmeans_fit(torch.Generator().manual_seed(0), x, w, 2,
                            n_iter=15, batch=9)[1]
    resp = torch.nn.functional.one_hot(labels, 2).to(torch.float32)
    with _OpCount() as off:
        p_off, s_off, active = gmm._em_fit(x, w, max_iter, 1e-6, resp)
    assert active is None
    with profile(activities=[ProfilerActivity.CPU]):
        with _OpCount() as on:
            p_on, s_on, active = gmm._em_fit(x, w, max_iter, 1e-6, resp)
    dv.reset_counters()
    assert active.shape == (9,)
    iters = off.ops['aten._softmax.default']
    assert 1 <= iters <= max_iter
    assert on.ops - off.ops == collections.Counter(
        {'aten.zeros.default': 1, 'aten.add_.Tensor': iters})
    assert not off.ops - on.ops
    torch.testing.assert_close(s_on, s_off, rtol=0, atol=0)
    for a, b in zip(p_on, p_off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
