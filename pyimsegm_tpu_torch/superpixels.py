"""Superpixel API under the reference's names (port of
``pyimsegm_tpu.superpixels``): :func:`segment_slic_img2d` from
``ops/slic.py``, :func:`segment_slic_img3d_gray` from ``ops/slic3d.py``,
:func:`superpixel_centers` over ``ops/graph.py``, and the host-side numpy
edge-list helpers with :func:`get_neighboring_segments`."""

import numpy as np

from pyimsegm_tpu_torch.ops import graph as graph_ops
from pyimsegm_tpu_torch.ops.slic import (  # noqa: F401  (public re-export)
    segment_slic_img2d,
)
from pyimsegm_tpu_torch.ops.slic3d import (  # noqa: F401
    segment_slic_img3d_gray,
)
from pyimsegm_tpu_torch.utils.device import as_tensor


def get_segment_diffs_2d_conn4(grid):
    """(a, b) label pairs of all horizontally and vertically adjacent
    pixels of a 2D label map."""
    grid = np.asarray(grid)
    a = np.concatenate([grid[:, :-1].ravel(), grid[:-1, :].ravel()])
    b = np.concatenate([grid[:, 1:].ravel(), grid[1:, :].ravel()])
    return np.stack([a, b], axis=1)


def get_segment_diffs_3d_conn6(grid):
    """conn6 pairs of a 3D label volume."""
    grid = np.asarray(grid)
    a = np.concatenate([grid[:, :, :-1].ravel(), grid[:, :-1, :].ravel(),
                        grid[:-1, :, :].ravel()])
    b = np.concatenate([grid[:, :, 1:].ravel(), grid[:, 1:, :].ravel(),
                        grid[1:, :, :].ravel()])
    return np.stack([a, b], axis=1)


def make_graph_segment_connect_edges(vertices, all_edges):
    """Unique undirected edges from raw pairs."""
    all_edges = np.asarray(all_edges)
    all_edges = all_edges[all_edges[:, 0] != all_edges[:, 1]]
    all_edges = np.sort(all_edges, axis=1)
    edges = np.unique(all_edges, axis=0)
    return vertices, edges


def make_graph_segm_connect_grid2d_conn4(grid):
    """(vertices, edges) superpixel adjacency of a 2D label map."""
    grid = np.asarray(grid)
    vertices = np.unique(grid)
    return make_graph_segment_connect_edges(
        vertices, get_segment_diffs_2d_conn4(grid))


def make_graph_segm_connect_grid3d_conn6(grid):
    """(vertices, edges) superpixel adjacency of a 3D label volume."""
    grid = np.asarray(grid)
    vertices = np.unique(grid)
    return make_graph_segment_connect_edges(
        vertices, get_segment_diffs_3d_conn6(grid))


def superpixel_centers(segments, device='cuda'):
    """Mean coordinate per superpixel of a label map or volume, (K, ndim)
    numpy with K = max + 1; a tensor runs on its device, anything else on
    ``device``."""
    segments = as_tensor(segments, device)
    k = int(segments.max()) + 1
    return graph_ops.superpixel_centers(segments, k,
                                        ndim=segments.ndim).cpu().numpy()


def get_neighboring_segments(edges):
    """Edge list -> per-node neighbour lists."""
    from pyimsegm_tpu_torch.region_growing import \
        get_neighboring_segments as _gns
    return _gns(edges)
