"""Reach + absorb from a given anchor seed (the wide-image route of the
connectivity enforcement): CUDA kernels, and the size predicates that pick
the reference's route.

Replaces ``pyimsegm_tpu.ops.connectivity_pallas.reach_absorb_pallas`` (row
13, two launches) and ``reach_absorb_fused_pallas`` (row 14, one launch)
with the cooperative kernels of ``csrc/connectivity.cu``.  As for row 12
(``ops/enforce_cuda.py``), the contract is the JAX package's global XLA
path, ``_connect_components`` with at most ``MAX_SWEEPS`` reach sweeps and
``2 * step`` absorb rounds, which the TPU kernels equal on a single band;
the card holds the whole plane, so there are no bands, and the plain twin
of both kernels is :func:`pyimsegm_tpu_torch.ops.enforce_cuda.
_connect_components`.

The predicates are the reference's pure size tests (its VMEM budgets for a
minimal band of each TPU kernel).  The port uses them only to take the
route the reference takes at each image size (``ops/grid.py``
``_enforce_route``): row 12 where ``fused_fits``, else the anchor seed and
row 14 where ``fused_ra_fits``, else row 13, which also takes the widths
where the reference falls back to its XLA scans (same semantics; the card
has no band limit).
"""

import functools

import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops.enforce_cuda import (MAX_SWEEPS,  # noqa: F401
                                                 _connect_components, _pack,
                                                 absorb_rounds)
from pyimsegm_tpu_torch.ops.slic import SlicConfig

#: max decided tile rows per band, and halo tile rows on each side
_BAND_R = 16
_HALO = 2
#: live (band_rows, pad_w) 4-byte planes of a band: the two-launch kernels,
#: the single-launch reach + absorb, and row 12's seed + reach + absorb
PLANES_2LAUNCH = 22
PLANES_FUSED_RA = 26
PLANES_FUSED = 42
#: VMEM budgets of the same kernels, bytes
VMEM_2LAUNCH = 64 * 1024 * 1024
VMEM_FUSED = 100 * 1024 * 1024

#: kernel launches in this process: two per ``reach_absorb`` call, one per
#: ``reach_absorb_fused`` call
LAUNCHES = {'reach_absorb': 0, 'reach_absorb_fused': 0}
#: the device flags of the last call on the card, for measurement:
#: ``flags[s] != 0`` (1 <= s < MAX_SWEEPS) says sweep s ran, and
#: ``flags[MAX_SWEEPS + 1 + i] != 0`` that absorb round i ran (i >= 1);
#: sweep 0 and round 0 always run (:func:`grid_passes`)
LAST_FLAGS = None


def band_rows_for(gh, step=None, wp=None, planes=PLANES_2LAUNCH,
                  budget=VMEM_2LAUNCH):
    """Decided tile rows per band: the smallest band height that still needs
    ``ceil(gh / cap)`` bands, the cap cut so that ``(r + 2 * _HALO) * step *
    wp * 4 * planes`` stays under ``budget`` when ``step`` and ``wp`` are
    given."""
    cap = _BAND_R
    if step is not None and wp is not None:
        rows_fit = budget // (planes * wp * 4)
        cap = max(1, min(cap, rows_fit // step - 2 * _HALO))
    n_bands = -(-gh // cap)
    return -(-gh // n_bands)


def band_fits(step, wp, planes=PLANES_2LAUNCH, budget=VMEM_2LAUNCH):
    """True when a minimal band (one decided tile row) fits the budget."""
    return (1 + 2 * _HALO) * step * planes * wp * 4 <= budget


def fused_ra_fits(cfg: SlicConfig):
    """The reference takes the single-launch reach + absorb (row 14)."""
    return band_fits(cfg.step, cfg.pad_w, PLANES_FUSED_RA, VMEM_2LAUNCH)


def fused_fits(cfg: SlicConfig):
    """The reference takes seed + reach + absorb in one kernel (row 12)."""
    return band_fits(cfg.step, cfg.pad_w, PLANES_FUSED, VMEM_FUSED)


@functools.cache
def _lib():
    v, i = _build.VOIDP, _build.INT
    sig = [v] * 3 + [i] * 7 + [v]
    return _build.load('connectivity', {'reach_absorb': sig,
                                        'reach_absorb_fused': sig})


def _launch(name, n_kernels, labels, reached0, cfg: SlicConfig):
    if not labels.is_cuda:
        return _connect_components(labels, reached0.to(torch.bool), cfg)
    h, w = labels.shape
    labels = _build.require(labels.contiguous(), 'labels', torch.int32,
                            (cfg.height, cfg.width))
    if reached0.device != labels.device:
        raise ValueError('reached0 on %s, labels on %s'
                         % (reached0.device, labels.device))
    out = labels.clone()
    reached = reached0.to(torch.uint8).contiguous().clone()
    n_rounds = absorb_rounds(cfg)
    # zeroed by the kernels
    flags = torch.empty((MAX_SWEEPS + 1 + n_rounds + 1,), dtype=torch.int32,
                        device=labels.device)
    _build.launch(getattr(_lib(), name), name, labels, out.data_ptr(),
                  reached.data_ptr(), flags.data_ptr(), h, w, cfg.grid_w,
                  cfg.step, _pack(cfg), MAX_SWEEPS, n_rounds)
    LAUNCHES[name] += n_kernels
    global LAST_FLAGS
    LAST_FLAGS = flags
    return out


def grid_passes(flags, cfg: SlicConfig):
    """(reach sweeps, absorb rounds) a call ran, from its device flags; each
    sweep or round is two passes over the plane (rows, then columns)."""
    flags = flags.cpu()
    rounds = flags[MAX_SWEEPS + 2:MAX_SWEEPS + 1 + absorb_rounds(cfg)]
    return (1 + int((flags[1:MAX_SWEEPS] != 0).sum()),
            1 + int((rounds != 0).sum()))


def reach_absorb(labels, reached0, cfg: SlicConfig):
    """Reach sweeps, then absorb rounds, from a given seed: two kernel
    launches, the reach plane kept in device memory between them (row 13).

    :param labels: (H, W) int32 grid-structured SLIC labels
    :param reached0: (H, W) bool or uint8 anchor seed
        (:func:`pyimsegm_tpu_torch.ops.enforce_cuda.anchor_seed`)
    :returns: (H, W) int32 labels, connected per superpixel
    """
    return _launch('reach_absorb', 2, labels, reached0, cfg)


def reach_absorb_fused(labels, reached0, cfg: SlicConfig):
    """:func:`reach_absorb` in one kernel launch (row 14)."""
    return _launch('reach_absorb_fused', 1, labels, reached0, cfg)
