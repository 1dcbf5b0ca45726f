"""The batched entry point of the port vs the JAX package on the CPU:
``parallel.batch.segment_images_batch`` on a stack of two images with one
fitted GMM class model handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import pipelines as jpipe
from pyimsegm_tpu.models.class_model import estim_class_model
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.parallel import batch as jbatch
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
from pyimsegm_tpu_torch.parallel import batch as tbatch
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

from torch_threads import one_torch_thread  # noqa: F401

SP, REGUL, GC = 16, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
SHAPE = (96, 140)


@pytest.fixture(scope='module')
def models():
    """A GMM fitted by the JAX package on two images, and its port."""
    cfg = jslic.slic_config(*SHAPE, SP)
    m = jslic.compactness_from_regul(SP, REGUL)
    spec = jpipe._features_spec(FEATURES)
    feats, masks = [], []
    for seed in (0, 1):
        img = sample_color_image_rand_segment(SHAPE, 3, rand_seed=seed)[0]
        _, f, counts, _ = jpipe._slic_features_core(jnp.asarray(img), cfg,
                                                    spec, m)
        feats.append(f)
        masks.append((counts > 0).astype(jnp.float32))
    jm = estim_class_model(jnp.concatenate(feats), 3, 'GMM',
                           sample_weight=jnp.concatenate(masks))
    arrays = {'weights': jm.gmm.weights, 'means': jm.gmm.means,
              'covs': jm.gmm.covs, 'scaler_mean': jm.scaler_mean,
              'scaler_scale': jm.scaler_scale}
    return jm, class_model_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope='module')
def images():
    return np.stack([sample_color_image_rand_segment(SHAPE, 3,
                                                     rand_seed=s)[0]
                     for s in (5, 6)])


def _batch(mod, images, model):
    return mod.segment_images_batch(images, model, FEATURES, sp_size=SP,
                                    sp_regul=REGUL, gc_regul=GC)


def test_segment_images_batch_matches_jax(models, images):
    jm, tm = models
    segm_j, prob_j = _batch(jbatch, images, jm)
    segm_t, prob_t = _batch(tbatch, images, tm)
    assert segm_t.shape == segm_j.shape and segm_t.dtype == np.int32
    assert prob_t.shape == prob_j.shape and np.isfinite(prob_t).all()
    for i in range(len(images)):
        assert adjusted_rand_score(segm_t[i], segm_j[i]) >= 0.98
        close = np.isclose(prob_t[i], prob_j[i], rtol=1e-5,
                           atol=1e-5).all(-1)
        assert close.mean() >= 0.99


def test_batch_equals_single_image_calls(models, images):
    """Image i of the batch is the single-image call on image i, exactly:
    the batch's device lookup and the single call's host gather agree on
    enforced labels."""
    _, tm = models
    segms, probs = _batch(tbatch, images, tm)
    for i, img in enumerate(images):
        segm, soft = tpipe.segment_color2d_slic_features_model_graphcut(
            img, tm, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC)
        np.testing.assert_array_equal(segms[i], segm)
        np.testing.assert_array_equal(probs[i], soft)


def test_mesh_raises(models, images):
    _, tm = models
    with pytest.raises(NotImplementedError):
        tbatch.segment_images_batch(images, tm, FEATURES, sp_size=SP,
                                    mesh=object())
