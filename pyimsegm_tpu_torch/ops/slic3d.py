"""3D anisotropic SLIC supervoxels, the reductions and lookups over them,
and the dense MRF on the supervoxel grid (port of
``pyimsegm_tpu.ops.slic3d``).

Seeds sit on a static (gz, gy, gx) grid with a per-axis step: a supervoxel
of nominal edge ``sp_size`` in the finest axis spans
``sp_size * min(spacing) / spacing[i]`` voxels along axis i.  Each voxel
competes among the 3x3x3 seeds around its own tile, so every label lies in
its voxel's 27-cell window; per-supervoxel sums are 27 masked tile sums
routed by grid shifts, and two adjacent voxels carry labels at most 3 cells
apart in an axis.

Dispatch goes by the tensor's device: :func:`slic3d_segment` calls
``ops/slic3d_cuda.slic3d_iterate``, which launches the kernels for a CUDA
volume and runs their plain twins (the JAX XLA path's operation order) for
a CPU one.  The grid sums, the lookup and the MRF are plain PyTorch on
either device, as the JAX package leaves them to XLA.
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyimsegm_tpu_torch.utils.device import as_tensor

#: the 27 candidate offsets (dz, dy, dx), in the order of the reference
OFFSETS3 = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
#: channel d of a (gz, gy, gx, 125) MRF weight tensor is the edge to the
#: seed at relative grid offset GRAPH_OFFSETS3[d] in [-2, 2]^3
GRAPH_OFFSETS3 = [(a, b, c) for a in range(-2, 3) for b in range(-2, 3)
                  for c in range(-2, 3)]


class Slic3DConfig(NamedTuple):
    shape: tuple       # (Z, H, W)
    steps: tuple       # per-axis seed step (voxels)
    grid: tuple        # per-axis number of seeds
    pad: tuple         # padded dims (grid * step)
    spacing: tuple     # physical voxel spacing

    @property
    def n_segments(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def slic3d_config(shape, sp_size, spacing=(1, 1, 1)) -> Slic3DConfig:
    spacing = tuple(float(s) for s in spacing)
    mn = min(spacing)
    steps = tuple(max(1, int(round(sp_size * mn / s))) for s in spacing)
    grid = tuple(max(1, math.ceil(d / st)) for d, st in zip(shape, steps))
    pad = tuple(g * st for g, st in zip(grid, steps))
    return Slic3DConfig(tuple(int(d) for d in shape), steps, grid, pad,
                        spacing)


def slic3d_weights(compactness, cfg: Slic3DConfig):
    """f32 weights of ``d = dc2 + ds2 * sw * m2`` as python floats:
    (spacing per axis, sw = 1 / nominal**2, m2 = m**2), where ``nominal`` is
    the largest physical tile edge."""
    sz, sy, sx = cfg.steps
    nominal = float(max(sz * cfg.spacing[0], sy * cfg.spacing[1],
                        sx * cfg.spacing[2]))
    spacing = tuple(float(np.float32(s)) for s in cfg.spacing)
    sw = float(np.float32(1.0 / nominal ** 2))
    m2 = float(np.float32(compactness) ** 2)
    return spacing, sw, m2


def _upsample3d(grid_arr, steps):
    """(gz, gy, gx, F) -> (gz*sz, gy*sy, gx*sx, F) by tile replication."""
    gz, gy, gx, f = grid_arr.shape
    sz, sy, sx = steps
    out = grid_arr[:, None, :, None, :, None, :].expand(gz, sz, gy, sy, gx,
                                                        sx, f)
    return out.reshape(gz * sz, gy * sy, gx * sx, f)


def _shift3d(grid, dz, dy, dx, fill=0):
    """Shift a (gz, gy, gx, ...) grid so cell (z, y, x) moves to
    (z+dz, y+dy, x+dx), filling vacated cells with ``fill``."""
    out = torch.full_like(grid, fill)
    dims = grid.shape[:3]
    if any(abs(d) >= n for d, n in zip((dz, dy, dx), dims)):
        return out
    dst = tuple(slice(max(d, 0), n + min(d, 0))
                for d, n in zip((dz, dy, dx), dims))
    src = tuple(slice(max(-d, 0), n + min(-d, 0))
                for d, n in zip((dz, dy, dx), dims))
    out[dst] = grid[src]
    return out


def _prep3d(volume, cfg: Slic3DConfig):
    """Normalise to [0, 1] by the volume's min / max, pad by repeating the
    last slice, row and column, and seed.

    :returns: (vol_p (pad_z, pad_h, pad_w) f32, centres0 (gz, gy, gx, 4)
        f32 [v, z, y, x])
    """
    z, h, w = cfg.shape
    gz, gy, gx = cfg.grid
    sz, sy, sx = cfg.steps
    dev = volume.device
    vol = volume.to(torch.float32)
    lo, hi = torch.aminmax(vol)
    vol = (vol - lo) / torch.clamp_min(hi - lo, 1e-12)
    idx = [torch.arange(p, device=dev).clamp_max(n - 1)
           for p, n in zip(cfg.pad, cfg.shape)]
    vol_p = vol[idx[0]][:, idx[1]][:, :, idx[2]].contiguous()

    def seeds(g, s, n):
        c0 = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * s - 0.5
        return c0, c0.to(torch.int64).clamp(0, n - 1)

    (z0, iz), (y0, iy), (x0, ix) = (seeds(gz, sz, z), seeds(gy, sy, h),
                                    seeds(gx, sx, w))
    init_val = vol[iz][:, iy][:, :, ix]
    zz, yy, xx = torch.meshgrid(z0, y0, x0, indexing='ij')
    return vol_p, torch.stack([init_val, zz, yy, xx], dim=-1)


def slic3d_segment(volume, cfg: Slic3DConfig, compactness, n_iter=10):
    """Supervoxel labels (Z, H, W) int32 in [0, K): n_iter - 1 assign +
    update rounds, then a final assignment.

    :param volume: (Z, H, W) float tensor (any scale); its device picks the
        kernels (CUDA) or the plain twins (CPU)
    :param compactness: SLIC compactness m
    """
    from pyimsegm_tpu_torch.ops.slic3d_cuda import slic3d_iterate
    vol_p, centers0 = _prep3d(volume, cfg)
    labels = slic3d_iterate(vol_p, centers0, compactness, cfg, n_iter)
    z, h, w = cfg.shape
    return labels[:z, :h, :w].contiguous()


def segment_slic_img3d_gray(volume, sp_size=50, relative_compact=0.1,
                            space=(1, 1, 1), n_iter=10, device='cuda'):
    """Supervoxel labels of a gray volume, with the reference's parameters.

    :param volume: (Z, H, W) volume; a tensor runs on its device, anything
        else on ``device``
    :returns: (Z, H, W) int32 numpy labels
    """
    from pyimsegm_tpu_torch.ops.slic import compactness_from_regul
    volume = as_tensor(volume, device)
    cfg = slic3d_config(tuple(volume.shape), sp_size, space)
    m = compactness_from_regul(sp_size, relative_compact)
    return slic3d_segment(volume, cfg, m, n_iter=n_iter).cpu().numpy()


# ------------------------------------------------ grid sums and lookup ---

def _window_offsets(labels, cfg: Slic3DConfig):
    """Per voxel of the (pad-filled with -2) label volume, the index of its
    label's cell in its own 27-cell window, or -1 for a negative label or
    one outside the window.  (pad_z, pad_h, pad_w) int64."""
    gz, gy, gx = cfg.grid
    sz, sy, sx = cfg.steps
    dp, hp, wp = cfg.pad
    z, h, w = labels.shape
    labels_p = torch.full(cfg.pad, -2, dtype=torch.int64,
                          device=labels.device)
    labels_p[:z, :h, :w] = labels
    lz = torch.div(labels_p, gy * gx, rounding_mode='floor')
    rem = labels_p - lz * (gy * gx)
    ly = torch.div(rem, gx, rounding_mode='floor')
    lx = rem - ly * gx
    dev = labels.device
    dz = lz - (torch.arange(dp, device=dev) // sz)[:, None, None] + 1
    dy = ly - (torch.arange(hp, device=dev) // sy)[None, :, None] + 1
    dx = lx - (torch.arange(wp, device=dev) // sx)[None, None, :] + 1
    ok = ((labels_p >= 0) & (dz >= 0) & (dz < 3) & (dy >= 0) & (dy < 3)
          & (dx >= 0) & (dx < 3))
    return torch.where(ok, dz * 9 + dy * 3 + dx, -1)


def grid3d_segment_sum(data, labels, cfg: Slic3DConfig):
    """Per-supervoxel sums of (Z, H, W, F) data over grid-structured labels:
    27 masked tile sums, each shifted to its target seed and added in offset
    order (a fixed order, so a run is deterministic).  A voxel whose label is
    negative or outside its 27-cell window adds nothing.

    :returns: (K, F) float32 sums
    """
    gz, gy, gx = cfg.grid
    sz, sy, sx = cfg.steps
    z, h, w = labels.shape
    f = data.shape[-1]
    data_p = torch.zeros(cfg.pad + (f,), dtype=torch.float32,
                         device=data.device)
    data_p[:z, :h, :w] = data
    off = _window_offsets(labels, cfg)
    sums = torch.zeros((gz, gy, gx, f), dtype=torch.float32,
                       device=data.device)
    for oi, (a, b, c) in enumerate(OFFSETS3):
        part = torch.where((off == oi)[..., None], data_p, 0.0) \
            .reshape(gz, sz, gy, sy, gx, sx, f).sum(dim=(1, 3, 5))
        sums = sums + _shift3d(part, a, b, c)
    return sums.reshape(gz * gy * gx, f)


def grid3d_geometry(labels, cfg: Slic3DConfig):
    """(counts (K,), centres (K, 3) in (z, y, x)) of grid-structured labels
    by one :func:`grid3d_segment_sum`; empty supervoxels get centre 0."""
    dev = labels.device
    coords = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev)
          for n in labels.shape], indexing='ij')
    sums = grid3d_segment_sum(
        torch.stack((torch.ones_like(coords[0]),) + coords, dim=-1),
        labels, cfg)
    counts = sums[:, 0]
    return counts, sums[:, 1:] / torch.clamp_min(counts[:, None], 1.0)


def grid3d_lookup(table, labels, cfg: Slic3DConfig):
    """Per-voxel ``table[labels]`` for grid-structured labels.  The table
    goes through f32 (integer tables come back exactly); a voxel whose label
    is negative or outside its 27-cell window reads 0.

    :param table: (K,) or (K, C)
    :param labels: (Z, H, W) integer
    :returns: (Z, H, W) or (Z, H, W, C), dtype of ``table``
    """
    squeeze = table.ndim == 1
    tab = table[:, None] if squeeze else table
    k = cfg.n_segments
    z, h, w = labels.shape
    ok = _window_offsets(labels, cfg)[:z, :h, :w] >= 0
    lab = labels.to(torch.int64)
    ok = ok & (lab < k)
    vals = tab.to(torch.float32)[torch.where(ok, lab, 0)]
    out = torch.where(ok[..., None], vals, 0.0).to(table.dtype)
    return out[..., 0] if squeeze else out


# --------------------------------------------------- supervoxel grid MRF ---

def _chan3d(d0, d1, d2):
    return ((d0 + 2) * 5 + (d1 + 2)) * 5 + (d2 + 2)


def wgrid3d_from_edges(edges, valid, weights, cfg: Slic3DConfig):
    """(gz, gy, gx, 125) symmetric edge-weight tensor from an edge list.

    Mirrors the reference's scatter exactly, including what it does with an
    edge whose cells lie 3 apart in an axis (two adjacent voxels whose labels
    sit on opposite sides of their windows): the channel index
    ``((dz+2)*5 + dy+2)*5 + dx+2`` then aliases another channel, wraps
    around when negative, and is dropped when >= 125.
    """
    gz, gy, gx = cfg.grid
    k = cfg.n_segments
    a = edges[:, 0].to(torch.int64)
    b = edges[:, 1].to(torch.int64)

    def cell(i):
        cz = torch.div(i, gy * gx, rounding_mode='floor')
        r = i - cz * (gy * gx)
        cy = torch.div(r, gx, rounding_mode='floor')
        return cz, cy, r - cy * gx

    az, ay, ax = cell(a)
    bz, by, bx = cell(b)
    w = torch.where(valid, weights.to(torch.float32), 0.0)
    wg = torch.zeros(k * 125 + 1, dtype=torch.float32, device=w.device)
    for src, ch in ((a, _chan3d(bz - az, by - ay, bx - ax)),
                    (b, _chan3d(az - bz, ay - by, ax - bx))):
        ch = torch.where(ch < 0, ch + 125, ch)
        flat = torch.where(ch < 125, src * 125 + ch, k * 125)
        # a slot takes one edge, or a few where channels alias, plus the
        # zeros of the padding slots; index_add_ (not the sort-based
        # index_put_, which serialises the padding's duplicate index)
        wg.index_add_(0, flat, w)
    return wg[:k * 125].reshape(gz, gy, gx, 125)


@functools.lru_cache(maxsize=8)
def _neighbor_index3d(grid, device):
    """(K, 125) flat index of the seed at each GRAPH_OFFSETS3 channel, or K
    (a zero row appended to the gathered table) off the grid."""
    gz, gy, gx = grid
    dev = torch.device(device)
    tz, ty, tx = torch.meshgrid(*[torch.arange(n, device=dev) for n in grid],
                                indexing='ij')
    off = torch.tensor(GRAPH_OFFSETS3, device=dev)
    nz = tz.reshape(-1, 1) + off[:, 0]
    ny = ty.reshape(-1, 1) + off[:, 1]
    nx = tx.reshape(-1, 1) + off[:, 2]
    ok = ((nz >= 0) & (nz < gz) & (ny >= 0) & (ny < gy) & (nx >= 0)
          & (nx < gx))
    return torch.where(ok, (nz * gy + ny) * gx + nx, gz * gy * gx)


def _neighbor_msg3d(qp, w125, nidx):
    """sum over the 125 neighbour channels of w * qp[neighbour]: one gather
    from the (K+1, C) table with a zero sentinel row, one product, one sum.

    :param qp: (K, C) per-cell class field
    :param w125: (K, 125) edge weights (0 where no edge)
    :param nidx: (K, 125) from :func:`_neighbor_index3d`
    """
    table = torch.cat([qp, qp.new_zeros((1, qp.shape[1]))])
    return (w125[..., None] * table[nidx]).sum(dim=1)


def grid3d_mrf_energy(labels_g, ug, wgrid, pairwise, nidx=None):
    """MRF energy of a per-cell labelling on the 125-neighbour structure
    (each undirected edge counted twice, so the pairwise term is halved).

    :param labels_g: (gz, gy, gx) or (K,) integer labels
    :param ug: (gz, gy, gx, C) or (K, C) unary costs
    :param wgrid: (gz, gy, gx, 125), or (K, 125) with ``nidx`` given
    :param nidx: (K, 125) from :func:`_neighbor_index3d`
    """
    c = ug.shape[-1]
    lab = labels_g.reshape(-1).long()
    ug = ug.reshape(-1, c)
    if nidx is None:
        nidx = _neighbor_index3d(tuple(wgrid.shape[:3]), str(ug.device))
    onehot = F.one_hot(lab, c).to(torch.float32)
    unary = torch.sum(torch.take_along_dim(ug, lab[:, None], 1))
    pw = torch.sum(onehot * _neighbor_msg3d(onehot @ pairwise.T,
                                            wgrid.reshape(-1, 125), nidx))
    return unary + 0.5 * pw


def solve_mrf_grid3d(unary, wgrid, pairwise, cfg: Slic3DConfig,
                     n_mf_iters=30, n_icm_iters=12, damping=0.5):
    """Damped mean-field, then synchronous ICM keeping the best-energy
    labelling, on the 125-neighbour supervoxel grid graph.  Runs on the
    device of ``unary`` with no host synchronisation.

    :param unary: (K, C)
    :param wgrid: (gz, gy, gx, 125)
    :param pairwise: (C, C)
    :returns: (K,) int32 labels
    """
    k, c = unary.shape
    ug = unary.to(torch.float32)
    w125 = wgrid.reshape(k, 125).to(torch.float32)
    pairwise = torch.as_tensor(pairwise, dtype=torch.float32,
                               device=ug.device)
    nidx = _neighbor_index3d(cfg.grid, str(ug.device))

    def message(q):
        return _neighbor_msg3d(q @ pairwise.T, w125, nidx)

    q = torch.softmax(-ug, dim=-1)
    for _ in range(n_mf_iters):
        q_new = torch.softmax(-(ug + message(q)), dim=-1)
        q = damping * q_new + (1.0 - damping) * q
    labels = torch.argmin(ug + message(q), dim=-1)

    best_labels = labels
    best_e = grid3d_mrf_energy(labels, ug, w125, pairwise, nidx)
    for _ in range(n_icm_iters):
        onehot = F.one_hot(labels, c).to(torch.float32)
        labels = torch.argmin(ug + message(onehot), dim=-1)
        e = grid3d_mrf_energy(labels, ug, w125, pairwise, nidx)
        improved = e < best_e
        best_labels = torch.where(improved, labels, best_labels)
        best_e = torch.where(improved, e, best_e)
    return best_labels.to(torch.int32)
