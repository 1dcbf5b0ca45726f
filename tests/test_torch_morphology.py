"""The port's morphology, annuli label histograms, 2D adjacency edges and
the windowed-histogram / ray twins of ``descriptors`` vs the JAX package on
the CPU.

Dilation, erosion, opening and closing are exact for every radius.  Disk
sums of integer planes are integers below 2**24, exact in f32 in any
order, so the histograms of a label map are exactly JAX's; those of
probability planes agree to rtol 1e-5 (the row cumsums round in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyimsegm_tpu import descriptors as jdesc
from pyimsegm_tpu.ops import graph as jgraph
from pyimsegm_tpu.ops import histogram as jhist
from pyimsegm_tpu.ops import morphology as jmorph
from pyimsegm_tpu_torch import descriptors as tdesc
from pyimsegm_tpu_torch.ops import graph as tgraph
from pyimsegm_tpu_torch.ops import histogram as thist
from pyimsegm_tpu_torch.ops import morphology as tmorph
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401

#: the scene size and annuli radii of the CPU tests (tests/test_centers.py)
SIZE, DIAMS = (128, 160), (4, 8, 16)


@pytest.fixture(scope='module')
def scene():
    return sample_ovary_scene(SIZE, 2, rand_seed=0)


@pytest.mark.parametrize('radius', [1, 3, 7])
@pytest.mark.parametrize('op', ['binary_dilation', 'binary_erosion',
                                'binary_opening', 'binary_closing'])
def test_binary_morphology_exact(op, radius):
    """Exact against JAX on a random mask, border pixels included."""
    mask = np.random.default_rng(radius).random((40, 50)) > 0.6
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(mask), radius))
    got = getattr(tmorph, op)(mask, radius, device='cpu')
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('radius', [1, 3, 7])
def test_disk_count_maps(radius):
    """Disk sums of 0/1 planes exactly JAX's (and the brute-force count);
    of random planes within rtol 1e-5; ``disk`` and ``_row_widths`` equal."""
    rng = np.random.default_rng(radius)
    ints = (rng.random((2, 3, 30, 41)) > 0.5).astype(np.float32)
    want = np.asarray(jmorph.disk_count_maps(jnp.asarray(ints), radius))
    got = tmorph.disk_count_maps(torch.as_tensor(ints), radius).numpy()
    np.testing.assert_array_equal(got, want)
    el = tmorph.disk(radius)
    np.testing.assert_array_equal(el, jmorph.disk(radius))
    assert tmorph._row_widths(radius) == jmorph._row_widths(radius)
    pad = np.pad(ints[0, 0], radius)
    brute = np.array([[np.sum(pad[i:i + 2 * radius + 1, j:j + 2 * radius + 1]
                              * el) for j in range(41)] for i in range(30)])
    np.testing.assert_array_equal(got[0, 0], brute)
    probs = rng.random((3, 30, 41)).astype(np.float32)
    np.testing.assert_allclose(
        tmorph.disk_count_map(torch.as_tensor(probs), radius).numpy(),
        np.asarray(jmorph.disk_count_map(jnp.asarray(probs), radius)),
        rtol=1e-5)


def test_label_histograms_exact_on_labels(scene):
    """Annuli histograms of the scene's label map at every pixel class and
    at clipped (out-of-image) positions: exactly JAX's, names equal."""
    _, segm, centres = scene
    rng = np.random.default_rng(0)
    pos = np.concatenate([centres.astype(int), rng.integers(-5, 170, (40, 2))])
    want, names_j = jhist.compute_label_histograms_positions(segm, pos, DIAMS)
    got, names_t = thist.compute_label_histograms_positions(segm, pos, DIAMS,
                                                            device='cpu')
    assert names_t == names_j
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cj, sj = jhist.label_hist_maps(jnp.asarray(segm), 4, DIAMS)
    ct, st = thist.label_hist_maps(torch.as_tensor(segm), 4, DIAMS)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert thist.HIST_CIRCLE_DIAGONALS == jhist.HIST_CIRCLE_DIAGONALS


def test_label_histograms_probability_planes(scene):
    """(H, W, L) probability planes: within rtol 1e-5 of JAX's."""
    rng = np.random.default_rng(1)
    prob = rng.random(SIZE + (3,)).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    pos = rng.integers(0, 128, (30, 2))
    want, _ = jhist.compute_label_histograms_positions(prob, pos, DIAMS)
    got, _ = thist.compute_label_histograms_positions(prob, pos, DIAMS,
                                                      device='cpu')
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_adjacency_edges_2d_exact():
    """The padded conn4 edge list and its mask of a non-grid label map, and
    one whose distinct pairs exceed the 8K capacity: exactly JAX's."""
    rng = np.random.default_rng(0)
    blocky = np.kron(rng.integers(0, 30, (8, 10)), np.ones((4, 4), int))
    noisy = rng.integers(0, 6, (20, 20))
    for labels, k in ((blocky, 30), (noisy, 6)):
        ej, vj = jgraph.adjacency_edges_2d(jnp.asarray(labels), k)
        et, vt = tgraph.adjacency_edges_2d(torch.as_tensor(labels), k)
        assert et.dtype == torch.int32
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) == 6 * 5 // 2


def test_descriptor_windows_and_ray_twins(scene):
    """The windowed histograms and the ray twins of ``descriptors``:
    exactly JAX's on the scene."""
    _, segm, centres = scene
    el = tmorph.disk(5)
    prob = np.stack([segm == lb for lb in range(4)], -1).astype(float)
    for pos in [(0, 0), (3, 150), tuple(centres[0].astype(int))]:
        assert tdesc.adjust_bounding_box_crop(SIZE, el.shape, pos) == \
            jdesc.adjust_bounding_box_crop(SIZE, el.shape, pos)
        for got, want in ((tdesc.compute_label_hist_segm(segm, pos, el, 4),
                           jdesc.compute_label_hist_segm(segm, pos, el, 4)),
                          (tdesc.compute_label_hist_proba(prob, pos, el),
                           jdesc.compute_label_hist_proba(prob, pos, el))):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    seg_b = segm == 0
    for edge in ('up', 'down'):
        centre = tuple(centres[1])
        host = tdesc.numpy_ray_features_seg2d(seg_b, centre, 20, edge)
        np.testing.assert_array_equal(
            host, jdesc.numpy_ray_features_seg2d(seg_b, centre, 20, edge))
        for fn in ('cython_ray_features_seg2d',
                   'compute_ray_features_segm_2d_vectors'):
            got = getattr(tdesc, fn)(seg_b, centre, 20, edge=edge,
                                     device='cpu')
            np.testing.assert_array_equal(
                got, getattr(jdesc, fn)(seg_b, centre, 20, edge=edge))
