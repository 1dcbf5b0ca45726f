"""The port's row-sharded SLIC and tiled pipeline
(``pyimsegm_tpu_torch.parallel.tiled``) on 1, 2 and 4 gloo ranks against
the JAX package's on 2- and 4-device meshes of the virtual CPU devices,
at 256x192 with sp_size 16 (16 seed rows, so 4 bands of 4).

Bars: the sharded SLIC labels equal JAX's on >= 0.999 of the pixels
(measured 0.99988 on 1, 2 and 4 ranks: the centres are f32 tile sums in
another order); the pipeline's segmentation ARS >= 0.98 and, relabelled by
best overlap, equal on >= 0.995 of the pixels (measured 1.0 and 1.0; each
side fits its own GMM with its own random draws, so the bar is
permutation-invariant); 2 and 4 ranks against 1 rank: labels equal on >=
0.999 of the pixels, soft maps within 1e-5 (measured: equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pyimsegm_tpu.ops.slic import gaussian_blur
from pyimsegm_tpu.parallel import tiled as jtiled
from pyimsegm_tpu_torch.parallel import tiled as ttiled
from pyimsegm_tpu_torch.utils.data_samples import \
    sample_color_image_rand_segment
from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

import torch_ranks
from torch_threads import one_torch_thread  # noqa: F401

SHAPE, SP, REGUL, GC = (256, 192), 16, 0.2, 1.0
FEATURES = {'color': ['mean', 'std', 'energy']}
RANKS = (1, 2, 4)
JAX_DEVICES = (2, 4)
SLIC_BAR, ARS_BAR, RELABEL_BAR = 0.999, 0.98, 0.995
RANK_BAR, SOFT_ATOL = 0.999, 1e-5


@pytest.fixture(scope='module')
def slic_image():
    """Smooth blobs, so the superpixels are meaningful (the JAX package's
    own sharded-SLIC test image)."""
    rng = np.random.default_rng(0)
    image = rng.random(SHAPE + (3,), dtype=np.float32)
    return np.array(gaussian_blur(jnp.asarray(image), 6.0))


@pytest.fixture(scope='module')
def pipe_image():
    """Three well separated colour classes."""
    return sample_color_image_rand_segment(SHAPE, 3, rand_seed=0)[0]


def _jax_mesh(n):
    devices = jax.devices()
    if len(devices) < n:
        pytest.skip('needs %d virtual devices' % n)
    return Mesh(np.array(devices[:n]), ('rows',))


@pytest.fixture(scope='module')
def jax_refs(slic_image, pipe_image):
    """JAX's sharded SLIC labels and tiled pipeline outputs per mesh size."""
    out = {}
    for n in JAX_DEVICES:
        mesh = _jax_mesh(n)
        out[n] = (jtiled.slic_segment_sharded(slic_image, SP, REGUL,
                                              mesh=mesh),
                  jtiled.pipe_color2d_slic_features_model_graphcut_tiled(
                      pipe_image, 3, FEATURES, sp_size=SP, sp_regul=REGUL,
                      gc_regul=GC, mesh=mesh))
    return out


@pytest.fixture(scope='module')
def port_runs(slic_image, pipe_image, tmp_path_factory):
    """Per rank count: (SLIC labels, (segm, soft)) of rank 0, after
    checking that every rank returned the same maps."""
    out = {}
    for world in RANKS:
        res = torch_ranks.spawn(
            torch_ranks.tiled, world, tmp_path_factory.mktemp('w%d' % world),
            slic_image, pipe_image, SP, REGUL, GC, FEATURES, 3)
        for other in res[1:]:
            for got, want in zip(other, res[0]):
                np.testing.assert_array_equal(got, want)
        out[world] = (res[0][0], res[0][1:])
    return out


def _relabelled_agreement(got, want):
    perm = np.full(int(want.max()) + 1, -1)
    for c in range(int(want.max()) + 1):
        sel = want == c
        if sel.any():
            perm[c] = np.bincount(got[sel]).argmax()
    return float(np.mean(perm[want] == got))


@pytest.mark.parametrize('world', JAX_DEVICES)
def test_sharded_slic_matches_jax(world, jax_refs, port_runs):
    got, want = port_runs[world][0], jax_refs[world][0]
    assert got.shape == SHAPE and got.dtype == np.int32
    assert np.mean(got == want) >= SLIC_BAR


@pytest.mark.parametrize('world', JAX_DEVICES)
def test_tiled_pipeline_matches_jax(world, jax_refs, port_runs):
    (segm, soft), (segm_j, _soft_j) = port_runs[world][1], jax_refs[world][1]
    assert segm.shape == SHAPE and segm.dtype == np.int32
    assert soft.shape == SHAPE + (3,) and soft.dtype == np.float32
    assert np.isfinite(soft).all()
    assert adjusted_rand_score(segm.ravel(), segm_j.ravel()) >= ARS_BAR
    assert _relabelled_agreement(segm, segm_j) >= RELABEL_BAR


@pytest.mark.parametrize('world', RANKS[1:])
def test_ranks_match_one_rank(world, port_runs):
    labels, (segm, soft) = port_runs[world]
    labels1, (segm1, soft1) = port_runs[1]
    assert np.mean(labels == labels1) >= RANK_BAR
    assert np.mean(segm == segm1) >= RANK_BAR
    assert np.abs(soft - soft1).max() <= SOFT_ATOL


def test_one_rank_tiled_slic_matches_jax(jax_refs, port_runs):
    """One band (no exchange) still assigns as JAX's 2-device mesh does."""
    assert np.mean(port_runs[1][0] == jax_refs[2][0]) >= SLIC_BAR


def test_tiled_pipeline_matches_single_card(pipe_image, port_runs):
    """Against the port's single-card pipeline on the same image, with the
    bars JAX holds its own tiled pipeline to (ARS and relabelled agreement
    >= 0.99 and 0.995; measured 0.99414 and 0.99805: the single-card path
    rounds the seed colours through bf16, the tiled pipeline does not)."""
    from pyimsegm_tpu_torch.pipelines import \
        pipe_color2d_slic_features_model_graphcut
    segm, _soft = port_runs[1][1]
    want, _ = pipe_color2d_slic_features_model_graphcut(
        pipe_image, 3, FEATURES, sp_size=SP, sp_regul=REGUL, gc_regul=GC,
        device='cpu')
    assert adjusted_rand_score(segm.ravel(), want.ravel()) >= 0.99
    assert _relabelled_agreement(segm, want) >= RELABEL_BAR


def test_shard_rows_must_divide():
    cfg = ttiled.slic_config(100, 64, 16)          # 7 seed rows
    assert ttiled._shard_rows(cfg, 7) == 1
    with pytest.raises(ValueError):
        ttiled._shard_rows(cfg, 2)


@pytest.mark.parametrize('features', [{'color': ['mean', 'median']},
                                      {'color': ['mean'], 'tLM': ['mean']}])
def test_tiled_pipeline_rejects_other_features(features):
    with pytest.raises(ValueError):
        ttiled.pipe_color2d_slic_features_model_graphcut_tiled(
            np.zeros((32, 32, 3), np.float32), 2, features, mesh=object())
