"""The port's native C++ host library (``pyimsegm_tpu_torch.native``)
against the JAX package's (``pyimsegm_tpu.native``) and the numpy twin.

The port builds its own copy of the source into ``build/torch_native/``;
both are the same C++, so the results must be equal: the union-find's
labels exactly (on JAX's skimage-compat raw SLIC labels, small and at
647x1024), alpha-expansion's labels exactly and its energy within
relative 1e-12 (measured: equal).  A failed build raises with the
compiler's output; with the library switched off the union-find runs the
numpy twin and alpha-expansion raises."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import native as jnative
from pyimsegm_tpu.ops import graphcut as jgraphcut
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu_torch import native as tnative
from pyimsegm_tpu_torch.ops import connectivity_host
from pyimsegm_tpu_torch.ops import graphcut as tgraphcut
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils.data_samples import (
    sample_color_image_rand_segment, sample_ovary_scene)

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
from make_torch_port_fixture import OUT_RG2SP, RG_SP  # noqa: E402

#: compat SLIC cases: image, sp_size, regul
CASES = {'ovary': (lambda: sample_ovary_scene((120, 200), 2,
                                              rand_seed=5)[0], 12, 0.2),
         'segments': (lambda: sample_color_image_rand_segment(
             (96, 150), 3, rand_seed=2)[0], 9, 0.3)}
GRAPH_SEEDS = (7, 8, 9)


@pytest.fixture(scope='module')
def raw_labels():
    """JAX's skimage-compat raw SLIC labels of each case, with the compat
    mode's size floor, and the fixture's 647x1024 ones."""
    out = {}
    for name, (make, sp, regul) in CASES.items():
        img = make()
        cfg = jslic.slic_config(img.shape[0], img.shape[1], sp)
        raw = np.asarray(jslic._slic_segment_xla_skimage(
            jnp.asarray(img), cfg, jslic.compactness_from_regul(sp, regul)))
        out[name] = (raw.astype(np.int32), int(0.5 * cfg.step * cfg.step))
    with np.load(OUT_RG2SP) as npz:
        cfg = tslic.slic_config(*npz['compat_raw'].shape, RG_SP)
        out['fixture'] = (npz['compat_raw'].astype(np.int32),
                          int(0.5 * cfg.step * cfg.step))
    return out


@pytest.mark.parametrize('min_size', [None, 1, 64])
@pytest.mark.parametrize('case', list(CASES) + ['fixture'])
def test_enforce_connectivity_matches_jax(case, min_size, raw_labels):
    raw, floor = raw_labels[case]
    min_size = floor if min_size is None else min_size
    got = tnative.enforce_connectivity(raw, min_size=min_size)
    assert got.dtype == np.int32 and got.shape == raw.shape
    np.testing.assert_array_equal(
        got, jnative.enforce_connectivity(raw, min_size=min_size))
    np.testing.assert_array_equal(
        got, connectivity_host.enforce_connectivity(raw, min_size=min_size))


def test_enforce_connectivity_accepts_tensors(raw_labels):
    raw, floor = raw_labels['ovary']
    got = tnative.enforce_connectivity(torch.as_tensor(raw.astype(np.int64)),
                                       min_size=floor)
    np.testing.assert_array_equal(got,
                                  tnative.enforce_connectivity(raw, floor))


def _graph(seed, k=300, c=4):
    """The adversarial random graph of the JAX package's oracle test."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, k, size=(3 * k, 2)).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    weights = rng.uniform(0.1, 2.0, size=len(edges)).astype(np.float32)
    unary = rng.uniform(0, 3, size=(k, c)).astype(np.float32)
    pairwise = np.float32(jgraphcut.create_pairwise_matrix_uniform(1.0, c))
    return edges, weights, unary, pairwise


@pytest.mark.parametrize('n_iter', [-1, 1])
@pytest.mark.parametrize('seed', GRAPH_SEEDS)
def test_alpha_expansion_matches_jax(seed, n_iter):
    graph = _graph(seed)
    got, e_got = tnative.alpha_expansion(*graph, n_iter=n_iter)
    want, e_want = jnative.alpha_expansion(*graph, n_iter=n_iter)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert abs(e_got - e_want) <= 1e-12 * abs(e_want)


@pytest.mark.parametrize('seed', GRAPH_SEEDS)
def test_alpha_expansion_from_labels_and_tensors(seed):
    """Tensor inputs and a given start; the start is not written to."""
    edges, weights, unary, pairwise = _graph(seed)
    init = np.random.default_rng(seed).integers(0, 4, len(unary)) \
        .astype(np.int32)
    start = init.copy()
    got, e_got = tnative.alpha_expansion(
        torch.as_tensor(edges), torch.as_tensor(weights),
        torch.as_tensor(unary), torch.as_tensor(pairwise),
        init_labels=torch.as_tensor(init))
    want, e_want = jnative.alpha_expansion(edges, weights, unary, pairwise,
                                           init_labels=init)
    np.testing.assert_array_equal(init, start)
    np.testing.assert_array_equal(got, want)
    assert abs(e_got - e_want) <= 1e-12 * abs(e_want)


@pytest.mark.parametrize('seed', GRAPH_SEEDS)
def test_solve_mrf_within_one_percent_of_exact(seed):
    """The port's edge-list solver on the CPU against the exact energy
    (the JAX package's bar: < 1%; measured gaps 0.0013, 0.0011 and 7e-9)."""
    graph = _graph(seed)
    _, e_exact = tnative.alpha_expansion(*graph)
    unary, edges, weights, pairwise = (torch.as_tensor(a) for a in (
        graph[2], graph[0], graph[1], graph[3]))
    labels = tgraphcut.solve_mrf(unary, edges, weights, pairwise)
    e_dev = float(tgraphcut.mrf_energy(labels, unary, edges, weights,
                                       pairwise))
    assert (e_dev - e_exact) / e_exact < 0.01


@pytest.mark.parametrize('fault', ['edge', 'label', 'pairwise'])
def test_alpha_expansion_rejects_bad_input(fault):
    """Indices the C++ would follow out of its buffers raise first."""
    edges, weights, unary, pairwise = _graph(GRAPH_SEEDS[0])
    init = None
    if fault == 'edge':
        edges = edges.copy()
        edges[3, 1] = len(unary)
    elif fault == 'label':
        init = np.zeros(len(unary), np.int32)
        init[5] = unary.shape[1]
    else:
        pairwise = pairwise[:3]
    with pytest.raises(ValueError):
        tnative.alpha_expansion(edges, weights, unary, pairwise,
                                init_labels=init)


def test_library_is_the_ports_own_build():
    assert tnative.has_native()
    path = tnative._lib_path()
    assert os.path.dirname(path) == os.path.join(ROOT, 'build',
                                                 'torch_native')
    assert tnative._LIB._name == path
    assert os.path.isfile(tnative._SRC)
    assert not tnative._SRC.startswith(os.path.join(ROOT, 'pyimsegm_tpu',
                                                    ''))


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / 'broken.cc'
    src.write_text('extern "C" int enforce_connectivity_2d( {\n')
    monkeypatch.setattr(tnative, '_SRC', str(src))
    monkeypatch.setattr(tnative, '_BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(tnative, '_LIB', None)
    with pytest.raises(RuntimeError, match='native build failed'):
        tnative.enforce_connectivity(np.zeros((4, 4), np.int32))
    with pytest.raises(RuntimeError, match='native build failed'):
        tnative.has_native()


def test_switched_off(monkeypatch, raw_labels):
    raw, floor = raw_labels['segments']
    monkeypatch.setattr(tnative, 'USE_NATIVE', False)
    monkeypatch.setattr(tnative, '_LIB', None)
    assert not tnative.has_native()
    np.testing.assert_array_equal(
        tnative.enforce_connectivity(raw, floor),
        connectivity_host.enforce_connectivity(raw, floor))
    with pytest.raises(RuntimeError):
        tnative.alpha_expansion(*_graph(GRAPH_SEEDS[0]))


@pytest.mark.parametrize('case', list(CASES))
def test_compat_slic_runs_the_native_union_find(case, monkeypatch):
    """``segment_slic_img2d(compat=True)`` is the device SLIC, then the
    native union-find, equal to the numpy twin on the same raw labels."""
    make, sp, regul = CASES[case]
    img = make()
    calls = []

    def spy(labels, min_size=16):
        calls.append(min_size)
        return enforce(labels, min_size)

    enforce = tnative.enforce_connectivity
    monkeypatch.setattr(tnative, 'enforce_connectivity', spy)
    got = tslic.segment_slic_img2d(img, sp_size=sp, relative_compact=regul,
                                   compat=True, device='cpu')
    raw = tslic.segment_slic_img2d(img, sp_size=sp, relative_compact=regul,
                                   compat=True, enforce_connectivity=False,
                                   device='cpu')
    cfg = tslic.slic_config(img.shape[0], img.shape[1], sp)
    assert calls == [int(0.5 * cfg.step * cfg.step)]
    np.testing.assert_array_equal(got, connectivity_host.enforce_connectivity(
        raw, calls[0]))
