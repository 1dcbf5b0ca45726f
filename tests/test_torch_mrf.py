"""The port's edge-list MRF (``ops/graphcut.py``: ``mrf_energy``,
``solve_mrf``, the generic 2D and 3D edge lists and weights, the label
transitions and their pairwise costs), ``ops/grid.wgrid_from_edges``, the
generic ``ops/graph.adjacency_edges_3d`` and the ``graph_cuts`` facade vs
the JAX package on the CPU.

Bars: edge lists and ``wgrid_from_edges`` exact (one weight per slot);
edge weights within rtol 1e-5; energies of one labelling within 1e-6
relative (f32 sums in another order); ``solve_mrf`` without expansion
chains (mean field + ICM): labels equal on >= 0.999 of the nodes and the
energy within 1e-5 relative; the full ``solve_mrf``, whose chains draw
their move noise from a ``torch.Generator`` (JAX's threefry bits are not
reproduced): energy at most 0.5% above JAX's on each graph and never
above the port's own mean-field + ICM state; transitions and their costs
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import graph_cuts as jgcs
from pyimsegm_tpu.ops import graph as jgraph
from pyimsegm_tpu.ops import graphcut as jgc
from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops.slic import segment_slic_img2d, slic_config
from pyimsegm_tpu_torch import graph_cuts as tgcs
from pyimsegm_tpu_torch.ops import graph as tgraph
from pyimsegm_tpu_torch.ops import graphcut as tgc
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops.slic import slic_config as tslic_config
from pyimsegm_tpu_torch.utils.data_samples import (
    sample_color_image_rand_segment)

from torch_threads import one_torch_thread  # noqa: F401

LABELS_BAR, ENERGY_RTOL, CHAIN_SLACK = 0.999, 1e-5, 0.005


def _random_graph(seed, k=500, c=4, density=3.0, regul=0.8):
    """A random planar-ish graph: unique edges lo < hi, padded with (0, 0)
    slots of weight 0 as the static edge lists are."""
    rng = np.random.default_rng(seed)
    n = int(k * density)
    a, b = rng.integers(0, k, n), rng.integers(0, k, n)
    keep = a != b
    edges = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)],
                               1)[keep], axis=0)
    edges = np.concatenate([edges, np.zeros((k // 4, 2), int)])
    w = rng.random(len(edges)).astype(np.float32)
    w[-(k // 4):] = 0
    unary = (rng.random((k, c)) * 3).astype(np.float32)
    pw = ((1 - np.eye(c)) * regul).astype(np.float32)
    return unary, edges.astype(np.int32), w, pw


#: one image shape and superpixel size for every SLIC of this file (one
#: JAX compile)
SHAPE, SP = (96, 128), 8


def _label_map(seed):
    """A random-segment image and JAX's SLIC labels of it."""
    img, _ = sample_color_image_rand_segment(SHAPE, 3, rand_seed=seed)
    slic = np.asarray(segment_slic_img2d(img, sp_size=SP,
                                         relative_compact=0.2))
    return img, slic


def _slic_graph(seed, c=3):
    """The edge list of JAX's SLIC labels of a random-segment image, with
    noisy unaries."""
    _, slic = _label_map(seed)
    k = int(slic.max()) + 1
    edges, valid = jgraph.adjacency_edges_2d(jnp.asarray(slic), k)
    rng = np.random.default_rng(seed)
    w = np.where(np.asarray(valid), rng.uniform(0.2, 2, len(valid)),
                 0).astype(np.float32)
    unary = (rng.random((k, c)) * 2).astype(np.float32)
    pw = ((1 - np.eye(c)) * 0.5).astype(np.float32)
    return unary, np.asarray(edges), w, pw


GRAPHS = {'random4': lambda: _random_graph(0),
          'random6': lambda: _random_graph(1, k=300, c=6, regul=1.5),
          'dense': lambda: _random_graph(2, k=200, c=3, density=8.0),
          'slic': lambda: _slic_graph(3)}


def _energy_np(labels, graph):
    unary, edges, w, pw = graph
    return float(jgc.mrf_energy(jnp.asarray(labels), jnp.asarray(unary),
                                jnp.asarray(edges), jnp.asarray(w),
                                jnp.asarray(pw)))


def _solve(pkg, graph, **kw):
    unary, edges, w, pw = graph
    if pkg == 'jax':
        return np.asarray(jgc.solve_mrf(jnp.asarray(unary), jnp.asarray(edges),
                                        jnp.asarray(w), jnp.asarray(pw), **kw))
    return tgc.solve_mrf(torch.as_tensor(unary), torch.as_tensor(edges),
                         torch.as_tensor(w), torch.as_tensor(pw),
                         **kw).numpy()


@pytest.mark.parametrize('name', list(GRAPHS))
def test_mrf_energy_matches_jax(name):
    graph = GRAPHS[name]()
    unary, edges, w, pw = graph
    lab = np.random.default_rng(5).integers(0, unary.shape[1], len(unary))
    got = float(tgc.mrf_energy(torch.as_tensor(lab), torch.as_tensor(unary),
                               torch.as_tensor(edges), torch.as_tensor(w),
                               torch.as_tensor(pw)))
    assert got == pytest.approx(_energy_np(lab, graph), rel=1e-6)
    batch = tgc.mrf_energy(torch.as_tensor(np.stack([lab, lab[::-1]])),
                           torch.as_tensor(unary), torch.as_tensor(edges),
                           torch.as_tensor(w), torch.as_tensor(pw))
    assert float(batch[0]) == got


@pytest.mark.parametrize('name', list(GRAPHS))
def test_solve_mrf_mean_field_icm_matches_jax(name):
    graph = GRAPHS[name]()
    want = _solve('jax', graph, n_expand_rounds=0)
    got = _solve('torch', graph, n_expand_rounds=0)
    assert got.dtype == np.int32
    assert (got == want).mean() >= LABELS_BAR
    assert _energy_np(got, graph) == pytest.approx(_energy_np(want, graph),
                                                   rel=ENERGY_RTOL)


@pytest.mark.parametrize('name', list(GRAPHS))
def test_solve_mrf_chains_energy(name):
    graph = GRAPHS[name]()
    e_jax = _energy_np(_solve('jax', graph), graph)
    e_own = _energy_np(_solve('torch', graph, n_expand_rounds=0), graph)
    e_full = _energy_np(_solve('torch', graph), graph)
    assert e_full <= e_jax * (1 + CHAIN_SLACK)
    assert e_full <= e_own
    light = dict(n_mf_iters=10, n_icm_iters=4, n_expand_rounds=2,
                 n_move_steps=4, n_chains=2)
    e_jl = _energy_np(_solve('jax', graph, **light), graph)
    assert _energy_np(_solve('torch', graph, **light), graph) \
        <= e_jl * (1 + CHAIN_SLACK)


def test_chain_orders_are_the_reference_draws():
    orders = tgc._chain_orders(5, 3, 2)
    rng = np.random.RandomState(0)
    want = [np.concatenate([rng.permutation(5) for _ in range(3)])
            for _ in range(2)]
    np.testing.assert_array_equal(orders, want)


def test_wgrid_from_edges_exact():
    _, slic = _label_map(4)
    cfg = slic_config(*SHAPE, SP)
    k = cfg.n_segments
    edges, valid = jgraph.adjacency_edges_2d(jnp.asarray(slic), k)
    w = np.random.default_rng(0).random(len(valid)).astype(np.float32)
    want = np.asarray(jgrid.wgrid_from_edges(edges, valid, jnp.asarray(w),
                                             cfg))
    got = tgrid.wgrid_from_edges(
        torch.as_tensor(np.asarray(edges)), torch.as_tensor(np.asarray(valid)),
        torch.as_tensor(w), tslic_config(*SHAPE, SP)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('edge_type', ['', 'spatial', 'color', 'features',
                                       'model', 'model_l1', 'model_l2'])
def test_edge_weights_2d_match_jax(edge_type):
    """The generic 2D edge list and every edge type (the raise of the grid
    slices is gone)."""
    img, slic = _label_map(6)
    k = int(slic.max()) + 1
    rng = np.random.default_rng(7)
    proba = rng.dirichlet(np.ones(3), k).astype(np.float32)
    feats = rng.random((k, 5)).astype(np.float32)
    ej, wj, vj = jgc.compute_edge_weights(
        jnp.asarray(slic), k, image=jnp.asarray(img),
        features=jnp.asarray(feats), proba=jnp.asarray(proba),
        edge_type=edge_type)
    et, wt, vt = tgc.compute_edge_weights(
        torch.as_tensor(slic), k, image=torch.as_tensor(img),
        features=torch.as_tensor(feats), proba=torch.as_tensor(proba),
        edge_type=edge_type)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-7)


def test_adjacency_edges_3d_generic_matches_jax():
    rng = np.random.default_rng(8)
    vol = rng.integers(0, 40, (6, 9, 11)).astype(np.int32)
    ej, vj = jgraph.adjacency_edges_3d(jnp.asarray(vol), 40)
    et, vt = tgraph.adjacency_edges_3d(torch.as_tensor(vol), 40)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize('regul', [0.0, 1.5])
def test_segment_graph_cut_general_edge_list(regul):
    """The generic route (no grid): 0 is the exact argmin, else the energy
    of the default schedule within the chains' slack of JAX's."""
    img, slic = _label_map(9)
    k = int(slic.max()) + 1
    proba = np.random.default_rng(10).dirichlet(np.ones(3), k) \
        .astype(np.float32)
    want = np.asarray(jgcs.segment_graph_cut_general(slic, proba, image=img,
                                                     gc_regul=regul))
    got = tgcs.segment_graph_cut_general(slic, proba, image=img,
                                         gc_regul=regul, device='cpu')
    if regul == 0:
        np.testing.assert_array_equal(got, want)
        return
    edges, w, _ = jgc.compute_edge_weights(jnp.asarray(slic), k,
                                           proba=jnp.asarray(proba),
                                           edge_type='model')
    graph = (np.asarray(jgc.compute_unary_cost(jnp.asarray(proba))),
             np.asarray(edges), np.asarray(w),
             np.asarray(jgc.compute_pairwise_cost(regul, 3), np.float32))
    assert _energy_np(got, graph) <= _energy_np(want, graph) \
        * (1 + CHAIN_SLACK)


def test_label_transitions_and_costs_match_jax():
    maps = [_label_map(s) for s in (11, 12)]
    rng = np.random.default_rng(13)
    slics = [m[1] for m in maps]
    labels = [rng.integers(0, 3, int(s.max()) + 1) for s in slics]
    want = jgc.count_label_transitions_connected_segments(slics, labels, 3)
    got = tgc.count_label_transitions_connected_segments(slics, labels, 3,
                                                         device='cpu')
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tgc.compute_pairwise_cost_from_transitions(got),
        jgc.compute_pairwise_cost_from_transitions(want))
    np.testing.assert_array_equal(
        tgc.compute_pairwise_cost_from_transitions(got[0]),
        jgc.compute_pairwise_cost_from_transitions(want[0]))


def test_graph_cuts_host_helpers_match_jax():
    rng = np.random.default_rng(14)
    feats = rng.random((50, 3))
    prob = rng.dirichlet(np.ones(2), 50)
    got, want = tgcs.estim_gmm_params(feats, prob), \
        jgcs.estim_gmm_params(feats, prob)
    for key in ('means', 'covars'):
        np.testing.assert_array_equal(got[key], want[key])
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    proba = rng.dirichlet(np.ones(3), 4)
    for metric in ('l1', 'l2', 'lT'):
        np.testing.assert_array_equal(tgcs.compute_edge_model(edges, proba,
                                                              metric),
                                      jgcs.compute_edge_model(edges, proba,
                                                              metric))
    spec = [((1, 2), 0.5), ((1, 0), 0.7)]
    np.testing.assert_array_equal(tgcs.create_pairwise_matrix_specif(spec),
                                  jgcs.create_pairwise_matrix_specif(spec))
    _, slic = _label_map(15)
    for a, b in zip(tgcs.get_vertexes_edges(slic),
                    jgcs.get_vertexes_edges(slic)):
        np.testing.assert_array_equal(a, b)
    cen = rng.random((4, 2))
    np.testing.assert_array_equal(
        tgcs.compute_spatial_dist(cen, edges, relative=True),
        jgcs.compute_spatial_dist(cen, edges, relative=True))
    tgcs.insert_gc_debug_images(None, slic, None, None, edges, None)
    with pytest.raises(NotImplementedError, match='item 9'):
        tgcs.insert_gc_debug_images({}, slic, None, None, edges, None)
