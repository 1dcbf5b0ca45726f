"""The port's mesh, distributed GMM-EM and mesh batch
(``pyimsegm_tpu_torch.parallel.batch``) on 1, 2 and 4 gloo ranks.

``distributed_gmm_em`` is held against the JAX package's on an 8-device
mesh of the virtual CPU devices, on the mixture of the JAX package's own
test (eight images of 64 three-dimensional samples from three well
separated Gaussians, 40 iterations): weights, means and covariances within
rtol 1e-4 and atol 1e-5 (measured: weights equal, means within 9.5e-7
and covariances within 1.2e-7 absolute on 1, 2 and 4 ranks).
``segment_images_batch`` on a 2-rank mesh gives the bits of
``mesh=None``; a batch that does not split evenly raises."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pyimsegm_tpu.parallel import batch as jbatch
from pyimsegm_tpu_torch.models.class_model import (class_model_to_numpy,
                                                   estim_class_model)
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.parallel import batch as tbatch
from pyimsegm_tpu_torch.pipelines import _features_spec, _slic_features_core
from pyimsegm_tpu_torch.utils.data_samples import \
    sample_color_image_rand_segment

import torch_ranks
from torch_threads import one_torch_thread  # noqa: F401

RANKS = (1, 2, 4)
N_ITER, SEED = 40, 1
RTOL, ATOL = 1e-4, 1e-5
SP, REGUL, GC = 16, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
SHAPE = (96, 140)


@pytest.fixture(scope='module')
def mixture():
    rng = np.random.default_rng(0)
    d, k, b = 3, 64, 8
    true_means = np.array([[0., 0, 0], [6, 6, 6], [-6, 6, 0]])
    feats = np.zeros((b, k, d), np.float32)
    for i in range(b):
        comp = rng.integers(0, 3, k)
        feats[i] = true_means[comp] + rng.normal(0, 0.7, (k, d))
    return feats, np.ones((b, k), np.float32)


@pytest.fixture(scope='module')
def jax_em(mixture):
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip('needs the 8-device virtual CPU mesh')
    params = jbatch.distributed_gmm_em(*mixture, 3,
                                       Mesh(np.array(devices[:8]), ('batch',)),
                                       n_iter=N_ITER, seed=SEED)
    return {k: np.asarray(v) for k, v in params._asdict().items()}


@pytest.fixture(scope='module')
def port_em(mixture, tmp_path_factory):
    """Per rank count, rank 0's parameters, after checking every rank got
    the same bits."""
    out = {}
    for world in RANKS:
        res = torch_ranks.spawn(torch_ranks.gmm_em, world,
                                tmp_path_factory.mktemp('em%d' % world),
                                *mixture, 3, N_ITER, SEED)
        for other in res[1:]:
            for key in other:
                np.testing.assert_array_equal(other[key], res[0][key])
        out[world] = res[0]
    return out


@pytest.mark.parametrize('key', ['weights', 'means', 'covs'])
@pytest.mark.parametrize('world', RANKS)
def test_distributed_gmm_em_matches_jax(world, key, jax_em, port_em):
    got, want = port_em[world][key], jax_em[key]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_distributed_gmm_em_recovers_mixture(port_em):
    """The JAX package's own bars on the pooled fit."""
    params = port_em[2]
    got = np.sort(params['means'], axis=0)
    want = np.sort(np.array([[0., 0, 0], [6, 6, 6], [-6, 6, 0]]), axis=0)
    assert np.allclose(got, want, atol=0.35)
    assert np.isclose(params['weights'].sum(), 1.0, atol=1e-5)
    assert np.all(params['weights'] > 0.15)


@pytest.fixture(scope='module')
def batch_inputs():
    """Four images and a GMM class model the port fits on two of them."""
    cfg = tslic.slic_config(*SHAPE, SP)
    m = tslic.compactness_from_regul(SP, REGUL)
    imgs = np.stack([sample_color_image_rand_segment(SHAPE, 3,
                                                     rand_seed=s)[0]
                     for s in range(4)])
    feats, masks = [], []
    for img in imgs[:2]:
        _, f, counts, _ = _slic_features_core(torch.as_tensor(img), cfg,
                                              _features_spec(FEATURES), m)
        feats.append(f)
        masks.append((counts > 0).to(torch.float32))
    model = estim_class_model(torch.cat(feats), 3, 'GMM',
                              sample_weight=torch.cat(masks))
    return imgs, class_model_to_numpy(model)


@pytest.fixture(scope='module')
def mesh_batch(batch_inputs, tmp_path_factory):
    imgs, arrays = batch_inputs
    return torch_ranks.spawn(
        torch_ranks.batch, 2, tmp_path_factory.mktemp('batch'), imgs, arrays,
        FEATURES, dict(sp_size=SP, sp_regul=REGUL, gc_regul=GC))


@pytest.mark.parametrize('rank', [0, 1])
def test_mesh_batch_equals_plain(rank, mesh_batch, batch_inputs):
    (segms, probs), (segms0, probs0), _ = mesh_batch[rank]
    assert segms.shape == (4,) + SHAPE and segms.dtype == np.int32
    assert probs.shape == (4,) + SHAPE + (3,) and probs.dtype == np.float32
    np.testing.assert_array_equal(segms, segms0)
    np.testing.assert_array_equal(probs, probs0)


@pytest.mark.parametrize('rank', [0, 1])
def test_mesh_batch_uneven_raises(rank, mesh_batch):
    assert 'does not split over 2 ranks' in mesh_batch[rank][2]


@pytest.fixture(scope='module')
def mesh_facts(tmp_path_factory):
    return torch_ranks.spawn(torch_ranks.mesh_facts, 2,
                             tmp_path_factory.mktemp('mesh'))


@pytest.mark.parametrize('rank', [0, 1])
def test_make_mesh(rank, mesh_facts):
    size, names, (index, n), too_big, in_first = mesh_facts[rank]
    assert (size, names, index, n) == (2, ('rows',), rank, 2)
    assert too_big == 'mesh of 3 ranks in a world of 2'
    assert in_first == ((0, 1) if rank == 0 else None)


def test_make_mesh_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        tbatch.make_mesh(device='cuda')
