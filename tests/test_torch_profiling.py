"""The port's stage profiling (``pyimsegm_tpu_torch.utils.profiling``) on
the CPU: the five prefix rows carry the JAX package's stage names, in its
order, with positive totals and deltas that sum to the whole; the timer
takes the host clock for a CPU result."""

import numpy as np
import pytest
import torch

from pyimsegm_tpu.utils import profiling as jprof
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.models import gmm as tgmm
from pyimsegm_tpu_torch.models.class_model import estim_class_model
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils import profiling as tprof
from pyimsegm_tpu_torch.utils.data_samples import \
    sample_color_image_rand_segment

from torch_threads import one_torch_thread  # noqa: F401

SP, REGUL = 16, 0.2
SHAPE = (64, 80)
FEATURES = {'color': ['mean', 'std', 'energy']}


def _jax_stage_names():
    """The names JAX's ``pipeline_stage_profile`` gives its prefixes, read
    without tracing them (``jax.jit`` compiles at the first call)."""
    seen = []
    original = jprof.profile_prefixes
    jprof.profile_prefixes = lambda prefixes, *a, **k: seen.extend(
        n for n, _ in prefixes) or []
    try:
        jprof.pipeline_stage_profile(np.zeros((1,) + SHAPE + (3,)), None,
                                     None, (), 1.0)
    finally:
        jprof.profile_prefixes = original
    return seen


def test_stage_profile_rows():
    images = np.stack([sample_color_image_rand_segment(SHAPE, 3,
                                                       rand_seed=s)[0]
                       for s in (0, 1)])
    cfg = tslic.slic_config(*SHAPE, SP)
    m = tslic.compactness_from_regul(SP, REGUL)
    spec = tpipe._features_spec(FEATURES)
    feats = torch.cat([tpipe._slic_features_core(torch.as_tensor(im), cfg,
                                                 spec, m)[1]
                       for im in images])
    model = estim_class_model(feats, 3, 'GMM')
    rows = tprof.pipeline_stage_profile(images, model, cfg, spec, m, reps=1,
                                        device='cpu')
    assert [r[0] for r in rows] == _jax_stage_names() == [
        'slic', 'features', 'model_proba', 'mrf', 'upsample(full)']
    assert all(total > 0 for _, total, _ in rows)
    np.testing.assert_allclose(sum(r[2] for r in rows), rows[-1][1])


def test_time_jitted_and_prefixes():
    calls = []

    def fn(x):
        calls.append(1)
        return {'out': (x * 2, None)}

    t = tprof.time_jitted(fn, torch.ones(4), reps=3, warmup=2)
    assert t > 0 and len(calls) == 5
    rows = tprof.profile_prefixes([('a', fn), ('b', fn)], torch.ones(4),
                                  reps=2)
    assert [r[0] for r in rows] == ['a', 'b']
    assert rows[0][1] == rows[0][2] and rows[1][2] == rows[1][1] - rows[0][1]
    assert tprof._first_tensor({'x': [None, (torch.zeros(1),)]}) is not None
    assert tprof._first_tensor(3) is None


@pytest.mark.parametrize('tf32', [False, True])
def test_full_precision_restores_settings(tf32):
    """``models.gmm.full_precision`` runs its function with TF32 off and
    'highest' matmul precision, then restores the caller's settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    seen = []

    @tgmm.full_precision
    def inner():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        raise KeyError('inside')

    try:
        # the matmul precision sets matmul.allow_tf32 too: 'high' turns it on
        torch.set_float32_matmul_precision('high' if tf32 else 'highest')
        torch.backends.cudnn.allow_tf32 = tf32
        before = (torch.backends.cuda.matmul.allow_tf32, tf32,
                  torch.get_float32_matmul_precision())
        with pytest.raises(KeyError):
            inner()
        assert seen == [(False, False, 'highest')]
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()) == before
        assert before[0] is tf32
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
