"""The port's label-map algebra (``pyimsegm_tpu_torch.labeling``) vs the
JAX package on the same numpy-seeded maps: integer outputs equal, and
distances equal (the same scipy transform runs on the same maps).  Every
function also takes a tensor."""

import numpy as np
import pytest
import torch

from pyimsegm_tpu import labeling as jlab
from pyimsegm_tpu_torch import labeling as tlab
from pyimsegm_tpu_torch.utils import ImageDimensionError
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 2)


def _maps(seed):
    """(blocky label map with 6 labels, finer map with 25, class map)."""
    rng = np.random.default_rng(seed)
    coarse = np.kron(rng.integers(0, 6, (6, 8)), np.ones((7, 9), int))
    fine = np.kron(rng.integers(0, 25, (14, 18)), np.ones((3, 4), int))
    classes = sample_ovary_scene((42, 72), 2, rand_seed=seed)[1]
    return coarse, fine, classes


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


CASES = {
    'segm_labels_assignment': lambda m, a, b, c: m.segm_labels_assignment(
        a, c),
    'assign_label_by_threshold': lambda m, a, b, c:
        m.assign_label_by_threshold(m.segm_labels_assignment(b, c), 0.6),
    'assign_label_by_max': lambda m, a, b, c:
        m.assign_label_by_max(m.segm_labels_assignment(b, c)),
    'convert_segms_2_list': lambda m, a, b, c: m.convert_segms_2_list(
        [a, b]),
    'mask_segm_labels': lambda m, a, b, c: m.mask_segm_labels(a, [1, 3]),
    'relabel_by_dict': lambda m, a, b, c: m.relabel_by_dict(
        a, {1: [0, 2], 2: [5]}),
    'merge_probab_labeling_2d': lambda m, a, b, c:
        m.merge_probab_labeling_2d(np.stack([a, b, c], -1) / 25.,
                                   {0: [0, 2], 1: [1]}),
    'histogram_regions_labels_norm': lambda m, a, b, c:
        m.histogram_regions_labels_norm(b, c, nb_labels=5),
    'compute_labels_overlap_matrix': lambda m, a, b, c:
        m.compute_labels_overlap_matrix(a, b),
    'relabel_max_overlap_unique': lambda m, a, b, c:
        m.relabel_max_overlap_unique(a, b, keep_bg=True),
    'relabel_max_overlap_merge': lambda m, a, b, c:
        m.relabel_max_overlap_merge(a, b),
    'relabel_max_overlap_merge_bg': lambda m, a, b, c:
        m.relabel_max_overlap_merge(c, b, keep_bg=True),
    'find_boundaries': lambda m, a, b, c: m.find_boundaries(b),
    'compute_boundary_distances': lambda m, a, b, c:
        m.compute_boundary_distances(c, b),
    'get_image2d_boundary_color': lambda m, a, b, c:
        m.get_image2d_boundary_color(a, size=2),
    'assume_bg_on_boundary': lambda m, a, b, c: m.assume_bg_on_boundary(
        a, bg_label=1, boundary_size=1),
    'contour_binary_map': lambda m, a, b, c: m.contour_binary_map(a, 3),
    'contour_binary_map_boundary': lambda m, a, b, c: m.contour_binary_map(
        a, 3, include_boundary=True),
    'contour_coords': lambda m, a, b, c: m.contour_coords(c, 1),
    'contour_coords_boundary': lambda m, a, b, c: m.contour_coords(
        a, 2, include_boundary=True),
    'binary_image_from_coords': lambda m, a, b, c:
        m.binary_image_from_coords(m.contour_coords(a, 4) + [[-1, 3],
                                                              [500, 2]],
                                   a.shape),
    'compute_distance_map': lambda m, a, b, c: m.compute_distance_map(c, 1),
    'neighbour_connect4': lambda m, a, b, c: [
        m.neighbour_connect4(a, a[i, j], (i, j))
        for i in range(1, 10) for j in range(1, 12)],
    'sequence_labels_merge': lambda m, a, b, c: m.sequence_labels_merge(
        np.stack([c, np.where(b % 3 == 0, 0, c), c]),
        {k: [] for k in range(int(c.max()) + 1)}, [0]),
}


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', sorted(CASES))
def test_labeling_matches_jax(name, seed):
    a, b, c = _maps(seed)
    _equal(CASES[name](tlab, a, b, c), CASES[name](jlab, a, b, c))


@pytest.mark.parametrize('name', ['compute_boundary_distances',
                                  'relabel_max_overlap_merge',
                                  'assume_bg_on_boundary',
                                  'histogram_regions_labels_norm'])
def test_labeling_takes_tensors(name):
    a, b, c = _maps(0)
    want = CASES[name](jlab, a, b, c)
    _equal(CASES[name](tlab, *(torch.as_tensor(x) for x in (a, b, c))), want)


def test_one_contingency_table_and_shape_errors():
    """The overlap counts come from ``utils.metrics``, and the shape check
    raises ``utils.ImageDimensionError`` (also under ``labeling``)."""
    from pyimsegm_tpu_torch.utils import metrics
    assert tlab.contingency_table is metrics.contingency_table
    assert tlab.ImageDimensionError is ImageDimensionError
    a, b, _ = _maps(0)
    for fn in (tlab.compute_boundary_distances, tlab.relabel_max_overlap_merge,
               tlab.segm_labels_assignment):
        with pytest.raises(ImageDimensionError):
            fn(a, b[:-1])
    assert tlab.histogram_regions_labels_counts(b, a).dtype == np.float32
