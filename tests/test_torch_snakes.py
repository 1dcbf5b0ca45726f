"""The port's multi-object morphological Chan-Vese
(``pyimsegm_tpu_torch.ops.snakes``) vs the JAX package on the CPU.

The region means are f32 sums, which the two packages add in another
order, so a pixel whose forcing is zero within rounding can flip: on the
scenes of ``tests/test_snakes.py`` the labels agree on >= 0.999 of the
pixels and each object's IoU with JAX's is >= 0.99.  On an integer-valued
scene every sum is exact in f32, and the labels are equal."""

import numpy as np
import pytest
import torch

from pyimsegm_tpu.ops import snakes as jsnakes
from pyimsegm_tpu_torch.ops import snakes as tsnakes

from torch_threads import one_torch_thread  # noqa: F401


def _two_disc_scene():
    rng = np.random.default_rng(0)
    img = np.full((80, 120), 0.1) + rng.normal(0, 0.02, (80, 120))
    yy, xx = np.mgrid[:80, :120]
    obj1 = ((yy - 40) ** 2 + (xx - 30) ** 2) <= 18 ** 2
    obj2 = ((yy - 40) ** 2 + (xx - 85) ** 2) <= 15 ** 2
    img[obj1], img[obj2] = 0.9, 0.85
    return img, obj1, obj2


def _scene(name):
    """(image, centres, radius) of the two scenes of tests/test_snakes.py."""
    img, _, _ = _two_disc_scene()
    if name == 'grow':
        return img, [(40, 30), (40, 85)], 6
    img[:, 60:] = 0.1
    return img, [(40, 30)], 30


def _ious(got, want, n):
    return [float(((got == lb) & (want == lb)).sum()
                  / max(((got == lb) | (want == lb)).sum(), 1))
            for lb in range(1, n + 1)]


@pytest.mark.parametrize('name', ['grow', 'shrink'])
@pytest.mark.parametrize('smoothing, lambdas', [(1, (1., 1.)), (3, (2., 1.)),
                                                (5, (3., 3.))])
def test_acwe_matches_jax(name, smoothing, lambdas):
    img, centres, radius = _scene(name)
    masks = tsnakes.circle_masks(img.shape, centres, radius)
    np.testing.assert_array_equal(
        masks, jsnakes.circle_masks(img.shape, centres, radius))
    want = np.asarray(jsnakes.morph_acwe_multi(
        img, masks, n_iter=80, smoothing=smoothing, lambda1=lambdas[0],
        lambda2=lambdas[1]))
    got = tsnakes.morph_acwe_multi(img, masks, n_iter=80, smoothing=smoothing,
                                   lambda1=lambdas[0], lambda2=lambdas[1],
                                   device='cpu')
    assert got.dtype == torch.int32 and got.shape == img.shape
    got = got.numpy()
    assert (got == want).mean() >= 0.999
    assert min(_ious(got, want, len(centres))) >= 0.99


@pytest.mark.parametrize('seed', [0, 1])
def test_acwe_integer_scene_exact(seed):
    """Integer intensities and three touching objects: every f32 sum is
    exact, so the labels, contested pixels included, are JAX's."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 3, (60, 90)).astype(np.float32)
    yy, xx = np.mgrid[:60, :90]
    centres = [(30, 25), (30, 45), (28, 66)]
    for i, (cy, cx) in enumerate(centres):
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) <= 12 ** 2
        img[disk] += 6 + 2 * i
    masks = tsnakes.circle_masks(img.shape, centres, 8)
    want = np.asarray(jsnakes.morph_acwe_multi(img, masks, n_iter=40,
                                               smoothing=2, lambda1=2.,
                                               lambda2=1.))
    got = tsnakes.morph_acwe_multi(torch.as_tensor(img), masks, n_iter=40,
                                   smoothing=2, lambda1=2., lambda2=1.)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 4


def test_acwe_empty_object_and_tensor_input():
    """An object whose disk lies off the image stays empty (the guarded
    mean), and a CPU tensor input runs on the CPU."""
    img, _, _ = _two_disc_scene()
    masks = tsnakes.circle_masks(img.shape, [(40, 30), (500, 500)], 6)
    want = np.asarray(jsnakes.morph_acwe_multi(img, masks, n_iter=30))
    got = tsnakes.morph_acwe_multi(torch.as_tensor(img), torch.as_tensor(
        masks), n_iter=30).numpy()
    assert (got == want).mean() >= 0.999
    assert not (got == 2).any()


def test_acwe_numpy_input_defaults_to_card():
    """A numpy input runs on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip('a card is present; this checks the refusal without one')
    img, _, _ = _two_disc_scene()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsnakes.morph_acwe_multi(img, tsnakes.circle_masks(
            img.shape, [(40, 30)], 6), n_iter=2)


@pytest.mark.parametrize('method', ['morph-snakes_img', 'morph-snakes_seg'])
def test_zoo_methods_match_the_app(method):
    """The ovary zoo's two snake methods on a small scene, as
    ``chip_smoke.py`` phase 14 builds them, against the app's own JAX
    entry point (the full-size case, 300 iterations at 647x1024, takes
    ~90 s on the CPU here, so the card holds it to the fixture)."""
    import chip_smoke
    from apps.run_ovary_egg_segmentation import (segment_morphsnakes,
                                                 simplify_segm_3cls)
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    img, segm, centres = sample_ovary_scene((128, 160), 2, rand_seed=1)
    np.testing.assert_array_equal(chip_smoke.simplify_segm_3cls(segm),
                                  simplify_segm_3cls(segm))
    image, masks, n_iter, smoothing, lambdas = chip_smoke.snake_call(
        method, img, segm, centres)
    assert n_iter == int(np.hypot(128, 160) / 2)
    if method == 'morph-snakes_img':
        want = segment_morphsnakes(img, centres)
    else:
        want = segment_morphsnakes(simplify_segm_3cls(segm), centres, True,
                                   smoothing, lambdas)
    got = tsnakes.morph_acwe_multi(image, masks, n_iter=n_iter,
                                   smoothing=smoothing, lambda1=lambdas[0],
                                   lambda2=lambdas[1], device='cpu').numpy()
    assert (got == want).mean() >= 0.999
    assert min(_ious(got, want, len(centres))) >= 0.99


def test_rest_fixture_is_whole():
    """The fixture ``chip_smoke.py`` phase 14 reads: JAX's SLIC of the
    test scene, both snake maps with an object for each egg, and the
    quantised indices, all of the scene's size."""
    import chip_smoke
    with np.load(chip_smoke.FIXTURE_REST) as npz:
        fx = {k: npz[k] for k in npz.files}
    assert sorted(fx) == ['morph_snakes_img', 'morph_snakes_seg', 'quant',
                          'slic']
    for v in fx.values():
        assert v.shape == chip_smoke.OVARY
    for key in ('morph_snakes_img', 'morph_snakes_seg'):
        assert set(np.unique(fx[key])) == set(range(chip_smoke.N_EGGS + 1))
