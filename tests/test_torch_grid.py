"""PyTorch grid ops and MRF vs the JAX package on the CPU.

``grid_lookup`` and ``grid_adjacency`` are held exactly against the JAX XLA
path and against the Pallas kernels they replace, run in interpret mode.
Labels come from the JAX SLIC of synthetic images made from numpy seeds,
and, at seed steps above 1024, from a numpy seed grid (``_grid_labels``).
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pyimsegm_tpu.ops import graphcut as jgc
from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops import grid_pallas
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch.ops import graphcut as tgc
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops import grid_cuda
from pyimsegm_tpu_torch.ops import slic as tslic

from torch_threads import one_torch_thread  # noqa: F401

SP = 16
#: (shape, sp_size) by id: the module's scenes, and a shape whose last tile
#: row and column are one pixel wide at sp_size 35
SCENES = {'even': ((96, 140), SP), 'padded': ((101, 133), SP),
          'one-px': ((71, 106), 35)}


@pytest.fixture(scope='module', params=['even', 'padded'])
def scene(request):
    """(labels (H, W) int32 numpy from the JAX SLIC, JAX cfg, torch cfg)."""
    shape, sp = SCENES[request.param]
    img = sample_color_image_rand_segment(shape, 3, rand_seed=3)[0]
    cfg = jslic.slic_config(*shape, sp)
    m = jslic.compactness_from_regul(sp, 0.2)
    labels = np.asarray(jslic._slic_segment_xla(jnp.asarray(img), cfg, m))
    return labels, cfg, tslic.slic_config(*shape, sp)


def _pallas_interpret(fn, *args):
    orig = pl.pallas_call
    calls = []

    def call(*a, **k):
        k['interpret'] = True
        calls.append(1)
        return orig(*a, **k)

    jax.clear_caches()
    with mock.patch.object(grid_pallas.pl, 'pallas_call', call):
        out = np.asarray(fn(*args))
    assert calls
    return out


def _damaged(labels, cfg, seed=0):
    """Labels with a sprinkle of -2, out-of-range and out-of-window ids."""
    rng = np.random.default_rng(seed)
    out = labels.copy()
    idx = rng.choice(out.size, size=out.size // 50, replace=False)
    vals = rng.choice([-2, -1, cfg.n_segments + 3, 0, cfg.n_segments - 1],
                      size=idx.size)
    out.ravel()[idx] = vals
    return out


def test_grid_lookup_matches_jax_and_pallas(scene):
    labels, cfg, tcfg = scene
    table = np.random.default_rng(1).random((cfg.n_segments, 3), np.float32)
    ref = np.asarray(jgrid.grid_lookup(jnp.asarray(table), jnp.asarray(labels),
                                       cfg))
    out = tgrid.grid_lookup(torch.as_tensor(table), torch.as_tensor(labels),
                            tcfg).numpy()
    np.testing.assert_array_equal(out, ref)
    pal = _pallas_interpret(grid_pallas.grid_lookup_pallas,
                            jnp.asarray(table), jnp.asarray(labels), cfg)
    np.testing.assert_array_equal(
        grid_cuda.grid_lookup(torch.as_tensor(table), torch.as_tensor(labels),
                              tcfg).numpy(), pal)


def test_grid_lookup_int_table_and_invalid_labels(scene):
    labels, cfg, tcfg = scene
    bad = _damaged(labels, cfg)
    table = np.arange(cfg.n_segments, dtype=np.int32) % 3
    ref = np.asarray(jgrid.grid_lookup(jnp.asarray(table), jnp.asarray(bad),
                                       cfg))
    out = tgrid.grid_lookup(torch.as_tensor(table), torch.as_tensor(bad), tcfg)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    ftab = np.random.default_rng(2).random((cfg.n_segments, 2), np.float32)
    pal = _pallas_interpret(grid_pallas.grid_lookup_pallas,
                            jnp.asarray(ftab), jnp.asarray(bad), cfg)
    np.testing.assert_array_equal(
        grid_cuda.grid_lookup(torch.as_tensor(ftab), torch.as_tensor(bad),
                              tcfg).numpy(), pal)


@pytest.mark.parametrize('dtype,c', [(np.int32, 1), (np.float32, 1),
                                     (np.float32, 4)],
                         ids=['C1-int32', 'C1-f32', 'C4-f32'])
def test_grid_lookup_main_path_tables_match_jax_and_pallas(scene, dtype, c):
    """Row 9 at the main path's C = 1 (the min-size merge's int32 donor
    table) and C = 4 (the batch's [graph label, proba] table), on labels
    with negative, out-of-range and out-of-window ids: the kernel's twin
    keeps the table's dtype and equals the JAX lookup and the Pallas kernel
    in interpret mode."""
    labels, cfg, tcfg = scene
    bad = _damaged(labels, cfg, seed=6)
    rng = np.random.default_rng(7)
    if dtype == np.int32:
        table = rng.integers(-1, cfg.n_segments + 2, (cfg.n_segments, c))
    else:
        table = rng.random((cfg.n_segments, c))
    table = table.astype(dtype)
    out = grid_cuda.grid_lookup(torch.as_tensor(table), torch.as_tensor(bad),
                                tcfg)
    assert out.dtype == torch.as_tensor(table).dtype
    ref = np.asarray(jgrid.grid_lookup(jnp.asarray(table), jnp.asarray(bad),
                                       cfg))
    np.testing.assert_array_equal(out.numpy(), ref)
    pal = _pallas_interpret(grid_pallas.grid_lookup_pallas,
                            jnp.asarray(table), jnp.asarray(bad), cfg)
    np.testing.assert_array_equal(out.numpy(), pal.astype(dtype))
    squeezed = tgrid.grid_lookup(torch.as_tensor(table[:, 0]),
                                 torch.as_tensor(bad), tcfg)
    np.testing.assert_array_equal(squeezed.numpy(), ref[..., 0])


@pytest.mark.parametrize('damage', [False, True], ids=['slic', 'damaged'])
@pytest.mark.parametrize('scene', list(SCENES), indirect=True)
def test_grid_adjacency_matches_jax_and_pallas(scene, damage):
    labels, cfg, tcfg = scene
    if damage:
        labels = _damaged(labels, cfg, seed=4)
    ref = np.asarray(jgrid.grid_adjacency(jnp.asarray(labels), cfg))
    out = tgrid.grid_adjacency(torch.as_tensor(labels), tcfg).numpy()
    np.testing.assert_array_equal(out, ref)
    pal = _pallas_interpret(grid_pallas.grid_adjacency_presence_pallas,
                            jnp.asarray(labels), cfg)           # (gh,gw,9,25)
    words = grid_cuda.grid_adjacency_presence(torch.as_tensor(labels), tcfg)
    bits = (words[..., None] >> torch.arange(25, dtype=torch.int32)) & 1
    np.testing.assert_array_equal(bits.numpy().astype(np.float32), pal)


def test_grid_segment_sum_matches_jax(scene):
    labels, cfg, tcfg = scene
    data = np.random.default_rng(5).normal(
        size=labels.shape + (4,)).astype(np.float32)
    ref = np.asarray(jgrid.grid_segment_sum(jnp.asarray(data),
                                            jnp.asarray(labels), cfg))
    out = tgrid.grid_segment_sum(torch.as_tensor(data),
                                 torch.as_tensor(labels), tcfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def _proba_centers(cfg, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(cfg.n_segments, 3))
    proba = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gy, gx = np.meshgrid(np.arange(cfg.grid_h), np.arange(cfg.grid_w),
                         indexing='ij')
    centers = np.stack([gy, gx], -1).reshape(-1, 2) * cfg.step \
        + rng.uniform(0, cfg.step, size=(cfg.n_segments, 2))
    return proba.astype(np.float32), centers.astype(np.float32)


@pytest.mark.parametrize('edge_type', ['model', 'model_l1', 'model_l2',
                                       'spatial', 'features', 'color', ''])
def test_grid_edge_weights_match_jax(scene, edge_type):
    labels, cfg, tcfg = scene
    proba, centers = _proba_centers(cfg, 6)
    rng = np.random.default_rng(8)
    features = rng.normal(size=(cfg.n_segments, 5)).astype(np.float32)
    mean_color = rng.random((cfg.n_segments, 3)).astype(np.float32)
    ref = np.asarray(jgrid.grid_edge_weights(
        jnp.asarray(labels), cfg, proba=jnp.asarray(proba),
        features=jnp.asarray(features), mean_color=jnp.asarray(mean_color),
        edge_type=edge_type, centers=jnp.asarray(centers)))
    out = tgrid.grid_edge_weights(
        torch.as_tensor(labels), tcfg, proba=torch.as_tensor(proba),
        features=torch.as_tensor(features),
        mean_color=torch.as_tensor(mean_color), edge_type=edge_type,
        centers=torch.as_tensor(centers)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_grid_edge_weights_centres_from_labels(scene):
    """Without given centres the weights reduce them from the labels."""
    labels, cfg, tcfg = scene
    proba, _ = _proba_centers(cfg, 7)
    ref = np.asarray(jgrid.grid_edge_weights(jnp.asarray(labels), cfg,
                                             proba=jnp.asarray(proba)))
    out = tgrid.grid_edge_weights(torch.as_tensor(labels), tcfg,
                                  proba=torch.as_tensor(proba)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_solve_mrf_grid_matches_jax(scene, seed):
    labels, cfg, tcfg = scene
    proba, centers = _proba_centers(cfg, 10 + seed)
    unary = np.asarray(jgc.compute_unary_cost(jnp.asarray(proba)))
    wgrid = np.asarray(jgrid.grid_edge_weights(
        jnp.asarray(labels), cfg, proba=jnp.asarray(proba),
        centers=jnp.asarray(centers)))
    pairwise = jgc.compute_pairwise_cost(2.0, 3).astype(np.float32)
    ref = np.asarray(jgrid.solve_mrf_grid(jnp.asarray(unary),
                                          jnp.asarray(wgrid),
                                          jnp.asarray(pairwise), cfg))
    out = tgrid.solve_mrf_grid(torch.as_tensor(unary), torch.as_tensor(wgrid),
                               torch.as_tensor(pairwise), tcfg)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    lab_grid = ref.reshape(cfg.grid_h, cfg.grid_w)
    e_ref = float(jgrid.grid_mrf_energy(
        jnp.asarray(lab_grid), jnp.asarray(unary).reshape(
            cfg.grid_h, cfg.grid_w, 3), jnp.asarray(wgrid),
        jnp.asarray(pairwise)))
    e_out = float(tgrid.grid_mrf_energy(
        torch.as_tensor(lab_grid), torch.as_tensor(unary).reshape(
            cfg.grid_h, cfg.grid_w, 3), torch.as_tensor(wgrid),
        torch.as_tensor(pairwise)))
    assert e_out == pytest.approx(e_ref, rel=1e-5)


def test_graph_cut_costs_and_argmin_shortcut(scene):
    labels, cfg, tcfg = scene
    proba, _ = _proba_centers(cfg, 20)
    np.testing.assert_allclose(
        tgc.compute_unary_cost(torch.as_tensor(proba)).numpy(),
        np.asarray(jgc.compute_unary_cost(jnp.asarray(proba))), rtol=1e-6)
    for regul in (2.0, np.array([[0., 1., 3.], [1., 0., 2.], [3., 2., 0.]]),
                  [((0, 1), 5.0)]):
        np.testing.assert_array_equal(tgc.compute_pairwise_cost(regul, 3),
                                      jgc.compute_pairwise_cost(regul, 3))
    ref = np.asarray(jgc.segment_graph_cut_general(
        jnp.asarray(labels), jnp.asarray(proba), cfg.n_segments, gc_regul=0))
    out = tgc.segment_graph_cut_general(
        torch.as_tensor(labels), torch.as_tensor(proba), cfg.n_segments,
        gc_regul=0)
    np.testing.assert_array_equal(out.numpy(), ref)
    # without its grid the map takes the edge-list solve (a raise until it
    # was ported): held to JAX's labels by energy
    got = tgc.segment_graph_cut_general(torch.as_tensor(labels),
                                        torch.as_tensor(proba),
                                        cfg.n_segments, gc_regul=1.0).numpy()
    want = np.asarray(jgc.segment_graph_cut_general(
        jnp.asarray(labels), jnp.asarray(proba), cfg.n_segments,
        gc_regul=1.0))
    edges, w, _ = jgc.compute_edge_weights(jnp.asarray(labels),
                                           cfg.n_segments,
                                           proba=jnp.asarray(proba),
                                           edge_type='model')
    unary = jgc.compute_unary_cost(jnp.asarray(proba))
    pw = jnp.asarray(jgc.compute_pairwise_cost(1.0, proba.shape[1]),
                     jnp.float32)

    def energy(lab):
        return float(jgc.mrf_energy(jnp.asarray(lab), unary, edges, w, pw))
    assert energy(got) <= energy(want) * 1.005


@pytest.mark.parametrize('edge_type', ['model', 'color'])
def test_segment_graph_cut_grid_matches_jax(scene, edge_type):
    labels, cfg, tcfg = scene
    proba, centers = _proba_centers(cfg, 21)
    image = sample_color_image_rand_segment(labels.shape, 3,
                                            rand_seed=3)[0] * 255.0
    ref = np.asarray(jgc.segment_graph_cut_general(
        jnp.asarray(labels), jnp.asarray(proba), cfg.n_segments,
        image=jnp.asarray(image), gc_regul=2.0, edge_type=edge_type,
        grid_ctx=(jnp.asarray(labels), cfg), centers=jnp.asarray(centers)))
    out = tgc.segment_graph_cut_general(
        torch.as_tensor(labels), torch.as_tensor(proba), cfg.n_segments,
        image=torch.as_tensor(image), gc_regul=2.0, edge_type=edge_type,
        grid_ctx=(torch.as_tensor(labels), tcfg),
        centers=torch.as_tensor(centers))
    np.testing.assert_array_equal(out.numpy(), ref)


def _grid_labels(shape, step, seed):
    """Grid-structured labels at seed step ``step``: each 5x5 block of
    pixels takes its tile's seed moved by a random offset in -1..1 (kept on
    the grid), then ids damaged as ``_damaged``."""
    h, w = shape
    gh, gw = math.ceil(h / step), math.ceil(w / step)
    rng = np.random.default_rng(seed)
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    moves = rng.integers(-1, 2, (2, (h + 4) // 5, (w + 4) // 5))
    sy = np.clip(y // step + moves[0][y // 5, x // 5], 0, gh - 1)
    sx = np.clip(x // step + moves[1][y // 5, x // 5], 0, gw - 1)
    cfg = jslic.slic_config(h, w, step)
    return _damaged((sy * gw + sx).astype(np.int32), cfg, seed), cfg


def _sums_agree(got, want):
    """rtol 1e-5 plus 1e-5 of the channel's largest sum: the sums are added
    in another order than JAX's."""
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * scale).all()


#: seed steps above the 1024 up to which row 7 took a step (row 6 took up
#: to 16384, rows 10 and 11 up to 4095; there JAX's XLA path, which pads
#: the image to whole tiles, materialises gigabytes); a wide and a tall
#: image of partial last tiles
BIG_STEPS = {'wide': ((40, 2100), 1025), 'tall': ((2100, 36), 1025)}


@pytest.mark.parametrize('geometry', list(BIG_STEPS))
@pytest.mark.parametrize('fn', ['grid_adjacency', 'grid_geometry_moments',
                                'counts_and_contacts', 'grid_segment_sum'])
def test_twins_match_jax_at_large_seed_steps(fn, geometry):
    """The twins that hold the CUDA kernels on the card, at a seed step above
    a kernel's former cap, against JAX's XLA path on damaged grid labels:
    adjacency and counts exact, sums within rtol 1e-5."""
    shape, step = BIG_STEPS[geometry]
    labels, cfg = _grid_labels(shape, step, seed=11)
    tcfg = tslic.slic_config(*shape, step)
    assert cfg.step == tcfg.step == step
    lab_j, lab_t = jnp.asarray(labels), torch.as_tensor(labels)
    data = np.random.default_rng(12).normal(size=shape + (3,)) \
        .astype(np.float32)
    if fn in ('grid_adjacency', 'counts_and_contacts'):
        ref = getattr(jgrid, fn)(lab_j, cfg)
        out = getattr(tgrid, fn)(lab_t, tcfg)
        for got, want in zip(out if isinstance(out, tuple) else (out,),
                             ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    ref = np.asarray(getattr(jgrid, fn)(jnp.asarray(data), lab_j, cfg))
    out = getattr(tgrid, fn)(torch.as_tensor(data), lab_t, tcfg).numpy()
    assert out.shape == ref.shape
    _sums_agree(out, ref)
