"""The wide-image route of the port's connectivity enforcement (reach +
absorb from the anchor seed, rows 13 and 14 of the kernel table) vs the JAX
package on the CPU.

The route predicate is held against JAX's own size predicates, the twins
of ``reach_absorb`` and ``reach_absorb_fused`` against JAX's XLA
``_connect_components`` (exact, given JAX's seed), the port's
``enforce_grid_connectivity`` against JAX's on one geometry of each route
(exact), and the twins against the two Pallas kernels in interpret mode on
a single band, where the banded kernels equal the global path.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pyimsegm_tpu.ops.connectivity_pallas as jcp
from pyimsegm_tpu.ops import enforce_pallas as jep
from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu_torch.ops import connectivity_cuda as tcc
from pyimsegm_tpu_torch.ops import enforce_cuda
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops import slic as tslic

from torch_threads import one_torch_thread  # noqa: F401

#: (height, width, sp_size): short, wide images over every route of the
#: reference (fused to 3535 px at sp 35, rafused to 3675, two to 4340, XLA
#: beyond), and the same predicates at other superpixel sizes
GEOMETRIES = [(70, 1200, 35), (70, 3535, 35), (70, 3536, 35), (70, 3600, 35),
              (70, 3675, 35), (70, 3676, 35), (70, 4096, 35), (70, 4340, 35),
              (70, 4341, 35), (70, 8192, 35), (50, 8192, 25), (50, 5000, 25),
              (40, 2300, 16), (40, 2600, 16), (60, 6000, 60), (60, 3000, 60)]


def _jax_route(cfg):
    if jep.fused_fits(cfg):
        return 'fused'
    if jcp.fused_ra_fits(cfg):
        return 'rafused'
    return 'two' if jcp.band_fits(cfg.step, cfg.pad_w) else 'xla'


def test_route_matches_the_reference_predicates():
    routes = set()
    for h, w, sp in GEOMETRIES:
        jcfg, tcfg = jslic.slic_config(h, w, sp), tslic.slic_config(h, w, sp)
        want = _jax_route(jcfg)
        routes.add(want)
        # the port's row 13 also takes the widths of the reference's XLA scans
        assert tgrid._enforce_route(tcfg) == \
            ('two' if want == 'xla' else want), (h, w, sp)
        for planes, budget in ((tcc.PLANES_2LAUNCH, tcc.VMEM_2LAUNCH),
                               (tcc.PLANES_FUSED_RA, tcc.VMEM_2LAUNCH),
                               (tcc.PLANES_FUSED, tcc.VMEM_FUSED)):
            assert tcc.band_rows_for(tcfg.grid_h, tcfg.step, tcfg.pad_w,
                                     planes, budget) == jcp.band_rows_for(
                jcfg.grid_h, jcfg.step, jcfg.pad_w, planes, budget)
    assert routes == {'fused', 'rafused', 'two', 'xla'}
    assert tcc.MAX_SWEEPS == jcp.MAX_SWEEPS


def _noise_labels(h, w, sp, seed):
    """JAX SLIC labels of a noise image: heavily fragmented superpixels."""
    img = np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)
    cfg = jslic.slic_config(h, w, sp)
    m = jslic.compactness_from_regul(sp, 0.2)
    return np.array(jslic.slic_segment(jnp.asarray(img), cfg, m)), cfg


def _window_noise_labels(h, w, sp, seed, block=3, frac=0.3):
    """Grid labels with ``frac`` of the ``block`` x ``block`` pixel blocks
    moved to a random seed of their tile's 3x3 window: fragments of every
    size, cheap at any width."""
    rng = np.random.default_rng(seed)
    cfg = jslic.slic_config(h, w, sp)
    ty = np.arange(h)[:, None] // sp
    tx = np.arange(w)[None, :] // sp
    by, bx = -(-h // block), -(-w // block)
    move = rng.random((by, bx)) < frac
    dy = np.where(move, rng.integers(-1, 2, (by, bx)), 0)
    dx = np.where(move, rng.integers(-1, 2, (by, bx)), 0)
    dy = np.repeat(np.repeat(dy, block, 0), block, 1)[:h, :w]
    dx = np.repeat(np.repeat(dx, block, 0), block, 1)[:h, :w]
    ly = np.clip(ty + dy, 0, cfg.grid_h - 1)
    lx = np.clip(tx + dx, 0, cfg.grid_w - 1)
    return (ly * cfg.grid_w + lx).astype(np.int32), cfg


def _jax_seed(labels, cfg):
    """The anchor seed exactly as JAX's XLA route builds it."""
    h, w = labels.shape
    lab = jnp.asarray(labels, jnp.int32)
    py = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    px = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sums = jgrid.grid_segment_sum(
        jnp.stack([jnp.ones((h, w), jnp.float32), py, px], axis=-1), lab, cfg)
    cyx = sums[:, 1:3] / jnp.maximum(sums[:, 0:1], 1.0)
    cpix = jgrid.grid_lookup(cyx, lab, cfg)
    d2 = (py - cpix[..., 0]) ** 2 + (px - cpix[..., 1]) ** 2
    d2min = jgrid.grid_segment_min(d2, lab, cfg)
    return np.asarray(d2 <= jgrid.grid_lookup(d2min, lab, cfg) + 1e-3), \
        np.asarray(cyx)


@pytest.mark.parametrize('shape,sp,seed', [((96, 128), 16, 0),
                                           ((101, 257), 12, 1)])
def test_twins_equal_jax_connect_components(shape, sp, seed):
    labels, jcfg = _noise_labels(*shape, sp, seed)
    tcfg = tslic.slic_config(*shape, sp)
    seed0, cyx = _jax_seed(labels, jcfg)
    want = np.asarray(jgrid._connect_components(jnp.asarray(labels),
                                                jnp.asarray(seed0), jcfg))
    assert (want != labels).any(), 'the absorb had nothing to do'
    lab_t = torch.as_tensor(labels)
    # the port's seed (row 12's seed kernels on the card) is JAX's
    seed_t = enforce_cuda.anchor_seed(lab_t, torch.as_tensor(cyx), tcfg)
    np.testing.assert_array_equal(seed_t.numpy(), seed0)
    for fn in (tcc.reach_absorb, tcc.reach_absorb_fused):
        got = fn(lab_t, torch.as_tensor(seed0), tcfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('shape,sp', [((70, 1200), 35), ((70, 3600), 35),
                                      ((70, 4096), 35), ((70, 4400), 35)],
                         ids=['fused', 'rafused', 'two', 'xla'])
def test_enforce_grid_connectivity_matches_jax_on_each_route(shape, sp):
    labels, jcfg = _window_noise_labels(*shape, sp, seed=3)
    tcfg = tslic.slic_config(*shape, sp)
    min_size = int(0.5 * sp * sp)
    want = np.asarray(jgrid.enforce_grid_connectivity(
        jnp.asarray(labels), jcfg, min_size=min_size))
    assert (want != labels).any()
    got = tgrid.enforce_grid_connectivity(torch.as_tensor(labels), tcfg,
                                          min_size=min_size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('fn,kernel,n_calls', [
    (tcc.reach_absorb, 'reach_absorb_pallas', 2),
    (tcc.reach_absorb_fused, 'reach_absorb_fused_pallas', 1)],
    ids=['two_launch', 'fused'])
def test_twins_match_pallas_kernels_on_one_band(fn, kernel, n_calls):
    """A single band (6 tile rows): the banded Pallas kernels equal the
    global path, so the twin must equal them exactly."""
    labels, jcfg = _noise_labels(96, 128, 16, 2)
    tcfg = tslic.slic_config(96, 128, 16)
    seed0, _ = _jax_seed(labels, jcfg)
    labels_p = jgrid._pad_to_grid(jnp.asarray(labels, jnp.int32), jcfg,
                                  fill=-9)
    seed_p = jgrid._pad_to_grid(jnp.asarray(seed0), jcfg, fill=False)
    orig_call = pl.pallas_call
    calls = []

    def interp_call(*args, **kwargs):
        kwargs['interpret'] = True
        calls.append(1)
        return orig_call(*args, **kwargs)

    with mock.patch.object(jcp.pl, 'pallas_call', interp_call):
        jax.clear_caches()
        want = np.asarray(getattr(jcp, kernel)(labels_p, seed_p, jcfg))
    assert len(calls) == n_calls
    got = fn(torch.as_tensor(labels), torch.as_tensor(seed0), tcfg)
    np.testing.assert_array_equal(got.numpy(), want[:96, :128])


def test_cpu_tensors_run_the_twin():
    """A CPU tensor runs the twin and counts no launch; the wrappers' CUDA
    branch is held on the card (chip_smoke.py phase 10)."""
    labels, _ = _window_noise_labels(40, 60, 10, 0)
    cfg = tslic.slic_config(40, 60, 10)
    before = dict(tcc.LAUNCHES)
    tcc.reach_absorb(torch.as_tensor(labels),
                     torch.ones(labels.shape, dtype=torch.bool), cfg)
    assert tcc.LAUNCHES == before
