"""PyTorch SLIC port vs the JAX package on the CPU.

The port's plain path (what a CPU tensor runs) is held against the JAX
functions as the JAX suite runs them here: the XLA formulation, and the
Pallas kernels in interpret mode for the kernel contracts.  Inputs are
synthetic images made from numpy seeds.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pyimsegm_tpu.ops import slic as jslic
from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
from pyimsegm_tpu_torch.ops import prep_cuda, slic_cuda
from pyimsegm_tpu_torch.ops import slic as tslic

from torch_threads import one_torch_thread  # noqa: F401

SP = 16
#: one shape whose tiles fit, one whose last tile row and column pad
SHAPES = [(96, 140), (101, 133)]


def _image(shape, seed=3):
    return sample_color_image_rand_segment(shape, 3, rand_seed=seed)[0]


def _interpret(module):
    """Run ``module``'s pallas_call in interpret mode and count the calls."""
    orig = pl.pallas_call
    calls = []

    def call(*args, **kwargs):
        kwargs['interpret'] = True
        calls.append(1)
        return orig(*args, **kwargs)

    jax.clear_caches()
    return mock.patch.object(module.pl, 'pallas_call', call), calls


def test_slic_config_matches_jax():
    for shape in SHAPES + [(7, 5), (884, 1200)]:
        for sp in (2, 16, 35):
            assert tuple(tslic.slic_config(*shape, sp)) == \
                tuple(jslic.slic_config(*shape, sp))
    assert tslic.compactness_from_regul(35, 0.2) == \
        jslic.compactness_from_regul(35, 0.2)
    assert tslic.DEFAULT_SLIC_ITERS == jslic.DEFAULT_SLIC_ITERS


@pytest.mark.parametrize('shape', SHAPES)
def test_prepare_chw_matches_jax(shape):
    img = _image(shape)
    cfg = jslic.slic_config(*shape, SP)
    lab_j, cen_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    lab_t, cen_t = tslic._prepare_chw(torch.as_tensor(img),
                                      tslic.slic_config(*shape, SP))
    assert lab_t.dtype == torch.bfloat16
    assert tuple(lab_t.shape) == (3, cfg.pad_h, cfg.pad_w)
    lab_j = np.asarray(lab_j.astype(jnp.float32))
    assert (lab_j == lab_t.float().numpy()).mean() >= 0.999
    np.testing.assert_allclose(cen_t.numpy(), np.asarray(cen_j), atol=1e-4)


@pytest.mark.parametrize('shape', SHAPES)
def test_gaussian_blur_and_lab_match_jax(shape):
    img = _image(shape, seed=5)
    blur_j = np.asarray(jslic.gaussian_blur(jnp.asarray(img), 1.0))
    blur_t = tslic.gaussian_blur(torch.as_tensor(img), 1.0).numpy()
    np.testing.assert_allclose(blur_t, blur_j, rtol=1e-5, atol=1e-6)
    lab_j = np.asarray(jslic._prepare_image(jnp.asarray(img)))
    lab_t = tslic._prepare_image(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(lab_t, lab_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('shape', SHAPES)
def test_blur_lab_plain_matches_pallas_interpret(shape):
    from pyimsegm_tpu.ops import prep_pallas
    img = _image(shape, seed=7)
    patch, calls = _interpret(prep_pallas)
    with patch:
        ref = np.asarray(prep_pallas.blur_lab_pallas(jnp.asarray(img))
                         .astype(jnp.float32))
    assert calls
    out = prep_cuda.blur_lab(torch.as_tensor(img)).float().numpy()
    assert out.shape == ref.shape
    assert (out == ref).mean() >= 0.999


def _prep_case(case):
    """Images of the preprocessing cases: smaller than the blur radius (h
    or w < 5, the symmetric reflection wraps more than once), constant (hi
    = lo), gray stacked to RGB, and in 0-255."""
    if case.startswith('tiny-'):
        shape = tuple(int(n) for n in case[5:].split('x'))
        return _image(shape, seed=2)
    img = _image((40, 52), seed=4)
    if case == 'constant':
        return np.full_like(img, 0.5)
    if case == 'gray':
        return np.repeat(img.mean(-1, keepdims=True), 3, -1)
    return img * np.float32(255.0)


@pytest.mark.parametrize('case', ['tiny-3x7', 'tiny-4x2', 'tiny-1x1',
                                  'constant', 'gray', 'range-255'])
def test_blur_lab_twin_small_constant_gray_match_jax(case):
    """The blur + Lab twin (``blur_lab`` on a CPU tensor) against JAX's
    ``_prepare_image`` (f32, the blur_lab test bar above) and against
    ``blur_lab_pallas`` in interpret mode: the same bf16 values, except
    where a channel is a cancellation near 0 (a and b of a gray image, L of
    a black or constant one), which may differ by at most 1e-4."""
    from pyimsegm_tpu.ops import prep_pallas
    img = _prep_case(case)
    lab_j = np.asarray(jslic._prepare_image(jnp.asarray(img)))
    lab_t = tslic._prepare_image(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(lab_t, lab_j, rtol=1e-5, atol=1e-4)
    patch, calls = _interpret(prep_pallas)
    with patch:
        ref = np.asarray(prep_pallas.blur_lab_pallas(jnp.asarray(img))
                         .astype(jnp.float32))
    assert calls
    out = prep_cuda.blur_lab(torch.as_tensor(img))
    assert out.dtype == torch.bfloat16 and out.shape == (3,) + img.shape[:2]
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    if case not in ('constant', 'gray'):
        assert (out == ref).mean() >= 0.999


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_segment_xla_matches_jax(shape):
    img = _image(shape)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    lj = np.asarray(jslic._slic_segment_xla(jnp.asarray(img), cfg, m))
    lt = tslic._slic_segment_xla(torch.as_tensor(img),
                                 tslic.slic_config(*shape, SP), m)
    assert lt.dtype == torch.int32 and tuple(lt.shape) == shape
    assert (lt.numpy() == lj).mean() >= 0.999


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_segment_with_features_matches_jax(shape):
    img = _image(shape, seed=11)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    ref = jslic.slic_segment_with_features(jnp.asarray(img), jnp.asarray(img),
                                           cfg, m)
    out = tslic.slic_segment_with_features(
        torch.as_tensor(img), torch.as_tensor(img),
        tslic.slic_config(*shape, SP), m)
    lt, lj = out[0].numpy(), np.asarray(ref[0])
    assert (lt == lj).mean() >= 0.999
    same = same_superpixels(lt, lj, cfg.n_segments)
    assert same.mean() >= 0.9
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-5, atol=1e-4)


def same_superpixels(labels_a, labels_b, k):
    """(K,) bool: superpixels that hold the same pixels in both maps (no
    pixel where the maps differ carries their label in either)."""
    diff = labels_a != labels_b
    touched = np.zeros(k, bool)
    touched[labels_a[diff]] = True
    touched[labels_b[diff]] = True
    return ~touched


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_kernel_twins_match_pallas_interpret(shape):
    """The plain twins of the two SLIC kernels against the Pallas kernels
    they replace.  From the same centres the final pass agrees exactly.  The
    Pallas kernels score candidates in dot-product form, which rounds
    differently from the explicit differences: over 9 update rounds a few
    pixels flip, each moving its centres by well under 0.1, so the chained
    result is held to the repo's Pallas-vs-XLA label bar (0.995)."""
    from pyimsegm_tpu.ops import slic_pallas
    img = _image(shape, seed=13)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    lab_j, cen0_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    sw2 = (jnp.float32(m) / cfg.step) ** 2
    feat = np.zeros((3, cfg.pad_h, cfg.pad_w), np.float32)
    feat[:, :shape[0], :shape[1]] = img.transpose(2, 0, 1)
    patch, calls = _interpret(slic_pallas)
    with patch:
        cen_j = slic_pallas.slic_multi_update_pallas(lab_j, cen0_j, sw2, cfg,
                                                     n_upd=9)
        lb_j, part_j = slic_pallas.slic_update_labels_pallas(
            lab_j, cen_j, sw2, cfg, feat_chw=jnp.asarray(feat))
    assert len(calls) == 2

    tcfg = tslic.slic_config(*shape, SP)
    lab_t = torch.as_tensor(np.array(lab_j.astype(jnp.float32))).to(
        torch.bfloat16)
    cen_t = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=9)
    np.testing.assert_allclose(cen_t.numpy(), np.asarray(cen_j), atol=0.1)
    lb_chain = slic_cuda.slic_update_labels(lab_t, cen_t, m, tcfg)[0]
    assert (lb_chain.numpy() == np.asarray(lb_j)).mean() >= 0.995

    lb_t, part_t, _ = slic_cuda.slic_update_labels(
        lab_t, torch.as_tensor(np.array(cen_j)), m, tcfg,
        feat=torch.as_tensor(img))
    assert lb_t.dtype == torch.int32
    assert (lb_t.numpy() == np.asarray(lb_j)).mean() >= 0.999
    assert part_t.shape == part_j.shape
    np.testing.assert_allclose(part_t.numpy(), np.asarray(part_j), rtol=1e-5,
                               atol=1e-3)


def test_combine_sums_matches_jax():
    from pyimsegm_tpu.ops import slic_pallas
    parts = np.random.default_rng(0).normal(size=(5, 7, 9, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        slic_cuda.combine_sums(torch.as_tensor(parts)).numpy(),
        np.asarray(slic_pallas.combine_sums(jnp.asarray(parts))))


#: an odd shape at an odd step: the last tile row and column partial
ROUTE_SHAPE, ROUTE_SP = (83, 117), 13


def test_update_labels_routed_sums_match_pallas_interpret():
    """Row 3's routed per-seed sums: the twin's equal ``combine_sums`` of its
    own partials, and JAX's ``slic_pallas.combine_sums`` of the partials of
    ``slic_update_labels_pallas`` in interpret mode from the same centres
    (rtol 1e-5 plus 1e-5 of the channel's largest sum: the partials are
    pooled in another order)."""
    from pyimsegm_tpu.ops import slic_pallas
    img = _image(ROUTE_SHAPE, seed=37)
    cfg = jslic.slic_config(*ROUTE_SHAPE, ROUTE_SP)
    m = jslic.compactness_from_regul(ROUTE_SP, 0.2)
    lab_j, cen0_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    tcfg = tslic.slic_config(*ROUTE_SHAPE, ROUTE_SP)
    lab_t = torch.as_tensor(np.array(lab_j.astype(jnp.float32))).to(
        torch.bfloat16)
    cen = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=3)
    feat = np.zeros((3, cfg.pad_h, cfg.pad_w), np.float32)
    feat[:, :ROUTE_SHAPE[0], :ROUTE_SHAPE[1]] = img.transpose(2, 0, 1)
    patch, calls = _interpret(slic_pallas)
    with patch:
        _, part_j = slic_pallas.slic_update_labels_pallas(
            lab_j, jnp.asarray(cen.numpy()), (jnp.float32(m) / cfg.step) ** 2,
            cfg, feat_chw=jnp.asarray(feat))
    assert calls
    want = np.asarray(slic_pallas.combine_sums(part_j))
    _, part_t, sums = slic_cuda.slic_update_labels(
        lab_t, cen, m, tcfg, feat=torch.as_tensor(img))
    assert tuple(sums.shape) == (cfg.grid_h, cfg.grid_w, 12)
    assert torch.equal(sums, slic_cuda.combine_sums(part_t))
    got = sums.numpy()
    scale = np.abs(want).max(axis=(0, 1), keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * scale).all()


@pytest.mark.parametrize('shape', SHAPES)
def test_update_labels_twin_pools_its_own_assignment(shape):
    """The final-pass partials are the per-(tile, offset) sums over exactly
    the labels the same pass writes, pad pixels excluded."""
    img = _image(shape, seed=17)
    cfg = tslic.slic_config(*shape, SP)
    m = tslic.compactness_from_regul(SP, 0.2)
    lab, cen0 = tslic._prepare_chw(torch.as_tensor(img), cfg)
    labels, part, routed = slic_cuda.slic_update_labels(
        lab, cen0, m, cfg, torch.as_tensor(img))
    sums = slic_cuda.combine_sums(part).reshape(cfg.n_segments, 12)
    assert torch.equal(routed.reshape(cfg.n_segments, 12), sums)
    lab_c = labels[:shape[0], :shape[1]].long().reshape(-1)
    counts = torch.bincount(lab_c, minlength=cfg.n_segments).float()
    np.testing.assert_array_equal(sums[:, 5].numpy(), counts.numpy())
    v0 = torch.zeros(cfg.n_segments).index_add_(
        0, lab_c, torch.as_tensor(img[..., 0]).reshape(-1))
    np.testing.assert_allclose(sums[:, 6].numpy(), v0.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('slico', [False, True], ids=['slic', 'slico'])
def test_slic_segment_matches_jax(shape, slico):
    """The labels-only SLIC, plain and SLICO, against the JAX XLA path."""
    img = _image(shape, seed=19)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    lj = np.asarray(jslic._slic_segment_xla(jnp.asarray(img), cfg, m,
                                            slico=slico))
    lt = tslic.slic_segment(torch.as_tensor(img),
                            tslic.slic_config(*shape, SP), m, slico=slico)
    assert lt.dtype == torch.int32 and tuple(lt.shape) == shape
    assert (lt.numpy() == lj).mean() >= 0.999
    geo = tslic.slic_segment_with_geometry(
        torch.as_tensor(img), tslic.slic_config(*shape, SP), m)
    ref = jslic.slic_segment_with_geometry(jnp.asarray(img), cfg, m)
    same = same_superpixels(geo[0].numpy(), np.asarray(ref[0]),
                            cfg.n_segments)
    for got, want in zip(geo[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('shape', SHAPES)
def test_slic_assign_update_twins_match_pallas_interpret(shape):
    """The labels-only and partials-only passes (and their split
    ``slic_iteration``) against ``slic_assign_pallas`` /
    ``slic_update_pallas`` from the same centres, plain and SLICO."""
    from pyimsegm_tpu.ops import slic_pallas
    img = _image(shape, seed=23)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    lab_j, cen0_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    sw2 = (jnp.float32(m) / cfg.step) ** 2
    sw2_slico = 1.0 / jnp.float32(cfg.step) ** 2
    tcfg = tslic.slic_config(*shape, SP)
    lab_t = torch.as_tensor(np.array(lab_j.astype(jnp.float32))).to(
        torch.bfloat16)
    cen_t = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=4)
    slico_t = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=4,
        slico=True)
    patch, calls = _interpret(slic_pallas)
    with patch:
        lb_j = slic_pallas.slic_assign_pallas(
            lab_j, jnp.asarray(cen_t.numpy()), sw2, cfg)
        part_j = slic_pallas.slic_update_pallas(
            lab_j, jnp.asarray(cen_t.numpy()), sw2, cfg)
        lbs_j = slic_pallas.slic_assign_pallas(
            lab_j, jnp.asarray(slico_t.numpy()), sw2_slico, cfg, slico=True)
    assert len(calls) == 3
    lb_t, part_t = slic_cuda.slic_iteration(lab_t, cen_t, m, tcfg)
    assert lb_t.dtype == torch.int32
    assert torch.equal(lb_t, slic_cuda.slic_assign(lab_t, cen_t, m, tcfg))
    assert (lb_t.numpy() == np.asarray(lb_j)).mean() >= 0.999
    assert part_t.shape == part_j.shape
    np.testing.assert_allclose(part_t.numpy(), np.asarray(part_j), rtol=1e-5,
                               atol=1e-3)
    lbs_t = slic_cuda.slic_assign(lab_t, slico_t, m, tcfg, slico=True)
    assert (lbs_t.numpy() == np.asarray(lbs_j)).mean() >= 0.999


@pytest.mark.parametrize('shape', SHAPES)
def test_slico_multi_update_twin_matches_pallas_interpret(shape):
    """Row 2's SLICO mode: centres and colour normalisers M of the plain
    twin against ``slic_multi_update_pallas(slico=True)`` after one round.
    The Pallas kernel scores in dot-product form, so a few pixels flip over
    more rounds; the labels after nine are held to the repo's
    Pallas-vs-XLA SLICO bar (0.995, ``tests/test_slic_multi_pallas.py``)."""
    from pyimsegm_tpu.ops import slic_pallas
    img = _image(shape, seed=29)
    cfg = jslic.slic_config(*shape, SP)
    m = jslic.compactness_from_regul(SP, 0.2)
    lab_j, cen0_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    sw2 = 1.0 / jnp.float32(cfg.step) ** 2
    patch, calls = _interpret(slic_pallas)
    with patch:
        one_j = slic_pallas.slic_multi_update_pallas(
            lab_j, cen0_j, sw2, cfg, n_upd=1, slico=True,
            init_m2=jnp.float32(m) ** 2)
        cen_j = slic_pallas.slic_multi_update_pallas(
            lab_j, cen0_j, sw2, cfg, n_upd=9, slico=True,
            init_m2=jnp.float32(m) ** 2)
        lb_j = slic_pallas.slic_assign_pallas(lab_j, cen_j, sw2, cfg,
                                              slico=True)
    assert calls
    tcfg = tslic.slic_config(*shape, SP)
    lab_t = torch.as_tensor(np.array(lab_j.astype(jnp.float32))).to(
        torch.bfloat16)
    one_t = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=1,
        slico=True)
    assert tuple(one_t.shape) == (cfg.grid_h, cfg.grid_w, 6)
    np.testing.assert_allclose(one_t.numpy(), np.asarray(one_j), rtol=1e-4,
                               atol=1e-3)
    cen_t = slic_cuda.slic_multi_update(
        lab_t, torch.as_tensor(np.array(cen0_j)), m, tcfg, n_upd=9,
        slico=True)
    lb_t = slic_cuda.slic_assign(lab_t, cen_t, m, tcfg, slico=True)
    assert (lb_t.numpy() == np.asarray(lb_j)).mean() >= 0.995
    assert torch.equal(
        slic_cuda.slic_multi_update(lab_t, torch.as_tensor(np.array(cen0_j)),
                                    m, tcfg, n_upd=0, slico=True)[..., 5],
        torch.full((cfg.grid_h, cfg.grid_w), float(np.float32(m) ** 2)))


#: the bench geometry cut so that the width is not a multiple of 4 and the
#: last tile row and column are partial, at the bench's sp_size
ODD, SP_ODD = (883, 1197), 35
#: the seed moved off the image's colours: it wins no pixel, so its
#: cluster stays empty and keeps its centre
EMPTY_SEED = (10, 10)


@pytest.fixture(scope='module')
def odd_scene():
    img = _image(ODD, seed=31)
    cfg = jslic.slic_config(*ODD, SP_ODD)
    lab_j, cen0_j = jslic._prepare_chw(jnp.asarray(img), cfg)
    cen0 = np.array(cen0_j)
    cen0[EMPTY_SEED + (0,)] = 1000.0            # L far beyond the image's
    lab_t = torch.as_tensor(np.array(lab_j.astype(jnp.float32))).to(
        torch.bfloat16)
    return lab_j, lab_t, cen0, cfg


@pytest.mark.parametrize('n_upd', [0, 1, 9])
@pytest.mark.parametrize('slico', [False, True], ids=['slic', 'slico'])
def test_slic_schedule_twin_matches_pallas_interpret_odd(odd_scene, n_upd,
                                                         slico):
    """Row 2's schedule twin against ``slic_multi_update_pallas`` at the odd
    geometry, from seeds of which one wins no pixel.  No round: the seeds
    themselves (SLICO: M = m**2).  After the rounds the empty cluster keeps
    its centre in both (SLICO: M = 1).  The Pallas kernel scores in
    dot-product form, so near-tie pixels flip: after one round the centres
    agree within 0.1 and M within 1e-3 relative, and the labels of a final
    assignment from each side's centres within the repo's Pallas-vs-XLA bar
    (0.999 after one round, 0.995 after nine); after nine rounds the flips
    have moved centres by at most 0.5 (SLICO, whose M follows one pixel's
    dc2: 2.0)."""
    from pyimsegm_tpu.ops import slic_pallas
    lab_j, lab_t, cen0, cfg = odd_scene
    m = jslic.compactness_from_regul(SP_ODD, 0.2)
    sw2 = (1.0 / jnp.float32(cfg.step) ** 2 if slico
           else (jnp.float32(m) / cfg.step) ** 2)
    kw = dict(slico=True, init_m2=jnp.float32(m) ** 2) if slico else {}
    patch, calls = _interpret(slic_pallas)
    with patch:
        cen_j = np.asarray(slic_pallas.slic_multi_update_pallas(
            lab_j, jnp.asarray(cen0), sw2, cfg, n_upd=n_upd, **kw))
        lb_j = np.asarray(slic_pallas.slic_assign_pallas(
            lab_j, jnp.asarray(cen_j), sw2, cfg, slico=slico))
    tcfg = tslic.slic_config(*ODD, SP_ODD)
    cen_t = slic_cuda.slic_multi_update(lab_t, torch.as_tensor(cen0), m, tcfg,
                                        n_upd=n_upd, slico=slico).numpy()
    assert cen_t.shape == cen_j.shape == (cfg.grid_h, cfg.grid_w,
                                          6 if slico else 5)
    if n_upd == 0:
        np.testing.assert_array_equal(cen_t, cen_j)
        np.testing.assert_array_equal(cen_t[..., :5], cen0)
        return
    assert calls
    for cen in (cen_t, cen_j):
        np.testing.assert_array_equal(cen[EMPTY_SEED][:5], cen0[EMPTY_SEED])
        if slico:
            assert cen[EMPTY_SEED][5] == 1.0
    lb_t = slic_cuda.slic_assign(lab_t, torch.as_tensor(cen_t), m, tcfg,
                                 slico=slico).numpy()
    if n_upd == 1:
        np.testing.assert_allclose(cen_t[..., :5], cen_j[..., :5], atol=0.1)
        if slico:
            np.testing.assert_allclose(cen_t[..., 5], cen_j[..., 5],
                                       rtol=1e-3)
        assert (lb_t == lb_j).mean() >= 0.999
    else:
        np.testing.assert_allclose(cen_t[..., :5], cen_j[..., :5],
                                   atol=2.0 if slico else 0.5)
        assert (lb_t == lb_j).mean() >= 0.995
