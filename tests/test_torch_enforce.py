"""Connectivity enforcement, pair counts, the min-size merge and the moments
reduce of the PyTorch port vs the JAX package on the CPU.

The twins of ``enforce_fused``, ``grid_pair_count`` and
``grid_moments_apply`` are held against the JAX XLA path (exact), and the
last two also against the Pallas kernels they replace, run in interpret
mode.  Labels come from the JAX SLIC of numpy-seeded images: smooth
synthetic scenes, and noise, whose fragmented superpixels make the absorb
and the min-size merge do real work.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from scipy import ndimage

from pyimsegm_tpu.ops import grid as jgrid
from pyimsegm_tpu.ops import grid_pallas
from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch import pipelines as tpipe
from pyimsegm_tpu_torch.ops import enforce_cuda
from pyimsegm_tpu_torch.ops import grid as tgrid
from pyimsegm_tpu_torch.ops import grid_cuda
from pyimsegm_tpu_torch.ops import slic as tslic
from pyimsegm_tpu_torch.utils.data_samples import sample_serpentine_labels

from torch_threads import one_torch_thread  # noqa: F401

SP = 16
SHAPES = [(96, 140), (101, 133)]
MIN_SIZE = int(0.5 * SP * SP)
#: the bench geometry cut so that the width is not a multiple of 4 (the
#: moments kernel takes its scalar path) and the last tile row and column
#: are partial, at the bench's sp_size
ODD, SP_ODD = (883, 1197), 35


def _image(shape, kind, seed):
    if kind == 'noise':
        return np.random.RandomState(seed).rand(*shape, 3).astype(np.float32)
    return sample_color_image_rand_segment(shape, 3, rand_seed=seed)[0]


class Scene:
    """SLIC labels (H, W) int32 from the JAX package, the image, both
    configs, and the JAX enforcement results, each computed once."""

    def __init__(self, shape, kind, sp=SP):
        self.img = _image(shape, kind, 5)
        self.cfg = jslic.slic_config(*shape, sp)
        self.tcfg = tslic.slic_config(*shape, sp)
        m = jslic.compactness_from_regul(sp, 0.2)
        self.labels = np.asarray(jslic.slic_segment(jnp.asarray(self.img),
                                                    self.cfg, m))
        self._enforced = {}

    def __iter__(self):
        return iter((self.labels, self.img, self.cfg, self.tcfg))

    def enforced(self, min_size=None):
        """JAX ``enforce_grid_connectivity`` of the labels."""
        if min_size not in self._enforced:
            self._enforced[min_size] = np.asarray(
                jgrid.enforce_grid_connectivity(
                    jnp.asarray(self.labels), self.cfg, min_size=min_size))
        return self._enforced[min_size]


RAW = [(SHAPES[0], 'noise'), (SHAPES[1], 'noise'), (SHAPES[1], 'scene')]
RAW_IDS = ['noise-even', 'noise-padded', 'scene-padded']


@pytest.fixture(scope='module', params=RAW, ids=RAW_IDS)
def raw(request):
    return Scene(*request.param)


def _centers(labels, cfg):
    """Centroids as ``enforce_grid_connectivity`` reduces them."""
    h, w = labels.shape
    coords = np.stack([np.ones((h, w)), *np.mgrid[:h, :w]], -1)
    sums = np.asarray(jgrid.grid_segment_sum(
        jnp.asarray(coords, jnp.float32), jnp.asarray(labels), cfg))
    return sums[:, 1:3] / np.maximum(sums[:, 0:1], 1.0)


def _pallas_interpret(fn, *args):
    orig = pl.pallas_call
    calls = []

    def call(*a, **k):
        k['interpret'] = True
        calls.append(1)
        return orig(*a, **k)

    fn.clear_cache()         # trace anew, so that the patch takes effect
    with mock.patch.object(grid_pallas.pl, 'pallas_call', call):
        out = jax.tree_util.tree_map(np.asarray, fn(*args))
    assert calls
    return out


@pytest.mark.parametrize('min_size', [None, MIN_SIZE], ids=['plain', 'merge'])
def test_enforce_grid_connectivity_matches_jax(raw, min_size):
    labels, _, cfg, tcfg = raw
    ref = raw.enforced(min_size)
    out = tgrid.enforce_grid_connectivity(torch.as_tensor(labels), tcfg,
                                          min_size=min_size)
    assert out.dtype == torch.int32
    assert (out.numpy() == ref).mean() >= 0.999
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != labels).any()


def test_enforce_twin_with_given_centres_matches_jax(raw):
    labels, _, cfg, tcfg = raw
    cyx = _centers(labels, cfg)     # what the JAX function reduces itself
    ref = raw.enforced()
    out = enforce_cuda.enforce_fused(torch.as_tensor(labels),
                                     torch.as_tensor(cyx), tcfg).numpy()
    np.testing.assert_array_equal(out, ref)


def test_enforce_with_empty_superpixel_matches_jax():
    """An empty superpixel (d2min = inf) reads as NaN through the
    reference's one-hot lookup in its 3x3 tile neighbourhood: those pixels
    are no anchors.  Empty a superpixel by moving its pixels to their own
    tile's seed, then compare."""
    labels, _, cfg, tcfg = Scene(SHAPES[1], 'scene')
    h, w = labels.shape
    own = (np.arange(h)[:, None] // SP) * cfg.grid_w + np.arange(w) // SP
    victim = cfg.grid_w + 1
    lab = np.where(labels == victim, own, labels).astype(np.int32)
    lab = np.where(lab == victim, own + 1, lab).astype(np.int32)
    assert not (lab == victim).any()
    ref = np.asarray(jgrid.enforce_grid_connectivity(jnp.asarray(lab), cfg,
                                                     min_size=MIN_SIZE))
    out = tgrid.enforce_grid_connectivity(torch.as_tensor(lab), tcfg,
                                          min_size=MIN_SIZE).numpy()
    np.testing.assert_array_equal(out, ref)


#: row 12's cases beyond the SLIC scenes above (``chip_smoke.py`` holds the
#: kernel against its twin on the same, ``chip_smoke.ENFORCE_CASES``):
#: (image kind, shape, sp_size) of fragmented noise labels and of a tall
#: image (the card's route has no bound on the height), and the serpentine
#: labels that need more reach sweeps than the cap
CASES = {'noise': ('noise', (128, 160), 8),
         'tall': ('scene', (2700, 48), 16),
         'caps': ('serpentine', (64, 80), 16)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_enforce_cases_match_jax(case):
    kind, shape, sp = CASES[case]
    cfg = jslic.slic_config(*shape, sp)
    tcfg = tslic.slic_config(*shape, sp)
    if kind == 'serpentine':
        labels = sample_serpentine_labels(sp)
    else:
        img = (np.random.RandomState(7).rand(*shape, 3).astype(np.float32)
               if kind == 'noise' else
               sample_color_image_rand_segment(shape, 3, rand_seed=2)[0])
        labels = np.asarray(jslic.slic_segment(
            jnp.asarray(img), cfg, jslic.compactness_from_regul(sp, 0.2)))
    assert labels.shape == shape
    ref = np.asarray(jgrid.enforce_grid_connectivity(jnp.asarray(labels),
                                                     cfg))
    out = tgrid.enforce_grid_connectivity(torch.as_tensor(labels), tcfg)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != labels).any()
    if case == 'caps':
        # the sweep cap binds: without it the labels differ
        with mock.patch.object(enforce_cuda, 'MAX_SWEEPS', 64):
            free = tgrid.enforce_grid_connectivity(torch.as_tensor(labels),
                                                   tcfg).numpy()
        assert (free != ref).any()


def test_enforced_output_connected_and_window_valid(raw):
    """Every enforced superpixel is one 4-connected region and lies in its
    pixels' 3x3 seed windows, so the host gather of ``_fetch_reconstruct``
    equals the grid lookup."""
    labels, _, cfg, tcfg = raw
    out = tgrid.enforce_grid_connectivity(torch.as_tensor(labels), tcfg,
                                          min_size=MIN_SIZE)
    got = out.numpy()
    st = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    bad = sum(int(ndimage.label(got == k, structure=st)[1] > 1)
              for k in np.unique(got))
    assert bad <= max(2, 0.02 * cfg.n_segments), bad
    h, w = got.shape
    assert (np.abs(got // cfg.grid_w - np.arange(h)[:, None] // SP) <= 1).all()
    assert (np.abs(got % cfg.grid_w - np.arange(w)[None, :] // SP) <= 1).all()
    rng = np.random.default_rng(0)
    proba = torch.as_tensor(rng.random((cfg.n_segments, 3), np.float32))
    graph = torch.as_tensor(rng.integers(0, 3, cfg.n_segments, np.int32))
    segm, soft = tpipe._fetch_reconstruct(out, proba, graph, tcfg)
    np.testing.assert_array_equal(segm,
                                  tgrid.grid_lookup(graph, out, tcfg).numpy())
    np.testing.assert_array_equal(soft,
                                  tgrid.grid_lookup(proba, out, tcfg).numpy())


def _damaged(labels, cfg, seed=0):
    """Labels with a sprinkle of -2, out-of-range and out-of-window ids."""
    rng = np.random.default_rng(seed)
    out = labels.copy()
    idx = rng.choice(out.size, size=out.size // 50, replace=False)
    out.ravel()[idx] = rng.choice(
        [-2, -1, cfg.n_segments + 3, 0, cfg.n_segments - 1], size=idx.size)
    return out


@pytest.mark.parametrize('damage', [False, True], ids=['slic', 'damaged'])
def test_grid_pair_count_matches_jax_and_pallas(raw, damage):
    labels, _, cfg, tcfg = raw
    if damage:
        labels = _damaged(labels, cfg, seed=2)
    cnt9, counts9 = grid_cuda.grid_pair_count(torch.as_tensor(labels), tcfg)
    pal = _pallas_interpret(grid_pallas.grid_pair_count_pallas,
                            jnp.asarray(labels), cfg)
    np.testing.assert_array_equal(cnt9.numpy(), pal[0])
    np.testing.assert_array_equal(counts9.numpy(), pal[1])
    ref = np.asarray(jgrid.grid_pair_count_channels(jnp.asarray(labels), cfg))
    out = tgrid.grid_pair_count_channels(torch.as_tensor(labels), tcfg)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_counts_and_contacts_match_jax(raw):
    labels, _, cfg, tcfg = raw
    enforced = raw.enforced()
    for lab in (labels, enforced):
        ref = jgrid.counts_and_contacts(jnp.asarray(lab), cfg)
        out = tgrid.counts_and_contacts(torch.as_tensor(lab), tcfg)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _beyond_k_bottom(labels, cfg, rows=2):
    """``labels`` with the last ``rows`` rows set to ids >= K of the seed row
    below the grid, in their tiles' windows: those pixels keep a routing
    offset, and the pixels above them pair with second endpoints >= K."""
    out = labels.copy()
    out[-rows:] = cfg.n_segments + np.arange(out.shape[1])[None] // cfg.step
    return out


@pytest.mark.parametrize('damage', ['holes', 'beyond-k', 'both'])
def test_counts_and_contacts_damaged_match_jax(raw, damage):
    """The routed pair-count twin (the triple of ``counts_and_contacts``)
    against JAX on damaged labels: -2, -1, out-of-window and beyond-K ids,
    and ids >= K inside the windows of the bottom tile row."""
    labels, _, cfg, tcfg = raw
    if damage != 'beyond-k':
        labels = _damaged(labels, cfg, seed=3)
    if damage != 'holes':
        labels = _beyond_k_bottom(labels, cfg)
    ref = jgrid.counts_and_contacts(jnp.asarray(labels), cfg)
    out = tgrid.counts_and_contacts(torch.as_tensor(labels), tcfg)
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ch(dy, dx):
    return (dy + 2) * 5 + (dx + 2)


def _row_tables(counts, contacts, gw, tile_of=None):
    """(counts, sym25, counts9) of a 1-row grid, as tests/test_minsize.py
    builds them; ``tile_of`` moves a label's pixels to another tile."""
    counts = np.asarray(counts, np.float32)
    sym25 = np.zeros((1, gw, 25), np.float32)
    for (a, b), n in contacts.items():
        sym25[0, a, _ch(0, b - a)] += n
        sym25[0, b, _ch(0, a - b)] += n
    counts9 = np.zeros((1, gw, 9), np.float32)
    counts9[0, :, 4] = counts
    for lab, tile in (tile_of or {}).items():
        counts9[0, lab, 4] = 0.0
        counts9[0, tile, 4 - (tile - lab)] = counts[lab]
    return counts, sym25, counts9


_CHAINS = {
    'blocked': ([5, 10, 1000, 1000], {(0, 1): 3, (1, 2): 4, (2, 3): 2}, 4,
                None, 50, 3),
    'extent': ([5, 10, 1000, 1000], {(0, 1): 3, (1, 2): 4, (2, 3): 2}, 4,
               {0: 1}, 50, 3),
    'tie': ([5, 5, 1000, 1000], {(0, 1): 3}, 4, None, 50, 3),
    'long': (list(range(5, 55, 5)) + [1000, 1000],
             {(i, i + 1): i + 1 for i in range(11)}, 12, None, 100, 3),
}


@pytest.mark.parametrize('case', sorted(_CHAINS))
@pytest.mark.parametrize('gated', [True, False], ids=['gated', 'ungated'])
def test_donor_chain_table_matches_jax(case, gated):
    counts, contacts, gw, tile_of, min_size, n_hops = _CHAINS[case]
    c, s25, c9 = _row_tables(counts, contacts, gw, tile_of)
    ref = np.asarray(jgrid.donor_chain_table(
        jnp.asarray(c), jnp.asarray(s25), 1, gw, min_size, n_hops=n_hops,
        counts9=jnp.asarray(c9) if gated else None))
    out = tgrid.donor_chain_table(
        torch.as_tensor(c), torch.as_tensor(s25), 1, gw, min_size,
        n_hops=n_hops, counts9=torch.as_tensor(c9) if gated else None)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_donor_tables_on_measured_counts_match_jax(raw):
    labels, _, cfg, tcfg = raw
    enforced = raw.enforced()
    c, s25, c9 = (np.asarray(a) for a in
                  jgrid.counts_and_contacts(jnp.asarray(enforced), cfg))
    gh, gw = cfg.grid_h, cfg.grid_w
    ref_d, ref_s = jgrid.donor_table_from_counts(
        jnp.asarray(c), jnp.asarray(s25), gh, gw, MIN_SIZE)
    out_d, out_s = tgrid.donor_table_from_counts(
        torch.as_tensor(c), torch.as_tensor(s25), gh, gw, MIN_SIZE)
    np.testing.assert_array_equal(out_d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    for got, want in zip(tgrid.label_tile_extents(torch.as_tensor(c9), gh, gw),
                         jgrid.label_tile_extents(jnp.asarray(c9), gh, gw)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = jgrid.donor_chain_table(jnp.asarray(c), jnp.asarray(s25), gh, gw,
                                  MIN_SIZE, counts9=jnp.asarray(c9))
    out = tgrid.donor_chain_table(torch.as_tensor(c), torch.as_tensor(s25),
                                  gh, gw, MIN_SIZE,
                                  counts9=torch.as_tensor(c9))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_min_size_merge_matches_jax(raw):
    labels, _, cfg, tcfg = raw
    enforced = raw.enforced()
    ref = np.asarray(jgrid.min_size_merge(jnp.asarray(enforced), cfg,
                                          MIN_SIZE))
    out = tgrid.min_size_merge(torch.as_tensor(enforced), tcfg, MIN_SIZE)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != enforced).any()


def _assert_sums_close(got, want):
    """rtol 1e-5 plus 1e-5 of the channel's largest value: the sums are
    added in another order."""
    scale = np.abs(want).max(axis=0, keepdims=True)
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-5 * np.abs(want) + 1e-5 * scale + 1e-30)


def test_enforce_minsize_with_moments_matches_jax(raw):
    labels, img, cfg, tcfg = raw
    cyx = _centers(labels, cfg)
    ref_l, ref_s = jgrid.enforce_minsize_with_moments(
        jnp.asarray(labels), cfg, MIN_SIZE, jnp.asarray(cyx),
        jnp.asarray(img))
    out_l, out_s = tgrid.enforce_minsize_with_moments(
        torch.as_tensor(labels), tcfg, MIN_SIZE, torch.as_tensor(cyx),
        torch.as_tensor(img))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))
    _assert_sums_close(out_s.numpy(), np.asarray(ref_s))


def _window_donor(cfg, seed):
    """A donor table whose targets are random seeds within +-1 grid cell
    (many pixels merge; those whose tile is further keep their label)."""
    rng = np.random.default_rng(seed)
    gy, gx = np.divmod(np.arange(cfg.n_segments), cfg.grid_w)
    ny = np.clip(gy + rng.integers(-1, 2, gy.size), 0, cfg.grid_h - 1)
    nx = np.clip(gx + rng.integers(-1, 2, gx.size), 0, cfg.grid_w - 1)
    return (ny * cfg.grid_w + nx).astype(np.int32)


@pytest.mark.parametrize('with_donor', [True, False],
                         ids=['apply', 'moments'])
@pytest.mark.parametrize('raw', RAW + [(ODD, 'scene', SP_ODD)],
                         ids=RAW_IDS + ['scene-odd'], indirect=True)
def test_grid_moments_apply_matches_pallas(raw, with_donor):
    labels, img, cfg, tcfg = raw
    enforced = raw.enforced()
    if with_donor:
        donor = _window_donor(cfg, 3)
        ref_l, ref_s = _pallas_interpret(
            grid_pallas.grid_moments_apply_pallas, jnp.asarray(img),
            jnp.asarray(enforced), jnp.asarray(donor), cfg)
        out_l, out_s = grid_cuda.grid_moments_apply(
            torch.as_tensor(img), torch.as_tensor(enforced),
            torch.as_tensor(donor), tcfg)
        np.testing.assert_array_equal(out_l.numpy(), ref_l)
        assert (ref_l != enforced).any()
    else:
        ref_s = _pallas_interpret(grid_pallas.grid_moments_pallas,
                                  jnp.asarray(img), jnp.asarray(enforced),
                                  cfg)
        out_s = tgrid.grid_geometry_moments(torch.as_tensor(img),
                                            torch.as_tensor(enforced), tcfg)
        want = np.asarray(jgrid.grid_geometry_moments(
            jnp.asarray(img), jnp.asarray(enforced), cfg))
        _assert_sums_close(out_s.numpy(), want)
    _assert_sums_close(out_s.numpy(), ref_s)
