"""The port's ``utils/drawing`` against the JAX package's on the CPU.

The array functions are numpy only in the port (matplotlib's path rule and
its ``jet`` / ``Greens`` tables are carried as numpy) and must equal JAX's
exactly: ellipse and polygon coordinates (also on polygons whose edges run
through lattice points, with integer and fractional vertices), the egg
masks, the overlaps and both colourings.  Every figure function renders
from the same numpy inputs as JAX's, at 50 dpi on Agg, to an equal RGBA
buffer.  Without matplotlib the figure functions raise ``ImportError``
naming it, and the array functions still run.  The cases mirror
``tests/test_drawing.py``'s."""

import os
import subprocess
import sys

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pyimsegm_tpu.utils import drawing as jdraw  # noqa: E402
from pyimsegm_tpu_torch.utils import drawing as tdraw  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DPI = 50
#: the figure functions and the ax-drawing functions, with the arguments
#: ``chip_smoke.py`` phase 15 draws them with where matplotlib is present
FIGURES = ('figure_image_adjustment',) + chip_smoke.FIGURE_FUNCS


def _eq(got, want):
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_closest_point_and_alpha():
    _eq(tdraw.closest_point_on_line([0, 0], [1, 2], [0, 2]),
        jdraw.closest_point_on_line([0, 0], [1, 2], [0, 2]))
    assert np.allclose(tdraw.closest_point_on_line([0, 0], [1, 2], [0, 2]),
                       [0.8, 1.6])
    for alpha in (-1., 0., 0.3, 1., 128., 300.):
        assert tdraw.norm_aplha(alpha) == jdraw.norm_aplha(alpha)


@pytest.mark.parametrize('orientation', [0., 0.4, 1.3, np.pi / 2])
def test_ellipse_coords(orientation):
    for args in ((15, 20, 8, 12), (2, 3, 9, 4), (28, 45, 6, 14)):
        _eq(tdraw.ellipse(*args, orientation=orientation, shape=(30, 50)),
            jdraw.ellipse(*args, orientation=orientation, shape=(30, 50)))
        _eq(tdraw.ellipse_perimeter(*args, orientation=orientation,
                                    shape=(30, 50)),
            jdraw.ellipse_perimeter(*args, orientation=orientation,
                                    shape=(30, 50)))


def test_polygon_fill_on_lattice_edges():
    """Matplotlib's crossing rule is not symmetric on lattice points that
    lie on an edge: the square (2, 2)-(8, 8) holds rows 3-7, columns 3-8."""
    got = tdraw.polygon_fill_coords([2, 2, 8, 8], [2, 8, 8, 2], (20, 20))
    _eq(got, jdraw.polygon_fill_coords([2, 2, 8, 8], [2, 8, 8, 2], (20, 20)))
    assert sorted(set(got[0].tolist())) == [3, 4, 5, 6, 7]
    assert sorted(set(got[1].tolist())) == [3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize('kind', ['integer', 'fractional', 'closed',
                                  'clipped'])
def test_polygon_fill_random(kind):
    """Random polygons of 3-7 vertices, integer or fractional, closed (the
    first vertex repeated) or reaching past the shape, against JAX's
    ``Path.contains_points``."""
    rng = np.random.default_rng(len(kind))
    for _ in range(200):
        n = int(rng.integers(3, 8))
        if kind == 'fractional':
            v = rng.uniform(0, 24, (n, 2))
        else:
            v = rng.integers(0, 24, (n, 2)).astype(float)
        if kind == 'closed':
            v = np.vstack([v, v[:1]])
        if kind == 'clipped':
            v = v * 1.6 - 8
        _eq(tdraw.polygon_fill_coords(v[:, 0], v[:, 1], (20, 22)),
            jdraw.polygon_fill_coords(v[:, 0], v[:, 1], (20, 22)))


def test_draw_eggs_and_merge():
    args = ([30, 50], [[10, 10]], [[20, 20]], [[35, 20]])
    mask = tdraw.draw_eggs_ellipse(*args)
    _eq(mask, jdraw.draw_eggs_ellipse(*args))
    assert mask.shape == (30, 50) and mask.max() == 1 and mask.sum() > 20
    eggs = ([30, 60], [[10, 10], [40, 8], [12, 11]],
            [[20, 20], [50, 15], [21, 19]], [[35, 20], [55, 25], [34, 21]])
    _eq(tdraw.draw_eggs_ellipse(*eggs), jdraw.draw_eggs_ellipse(*eggs))
    masks = tdraw.draw_eggs_rectangle(*eggs)
    want = jdraw.draw_eggs_rectangle(*eggs)
    assert len(masks) == len(want) == 3
    for m1, m2 in zip(masks, want):
        _eq(m1, m2)
    assert masks[0].sum() > 50
    _eq(tdraw.merge_object_masks(masks), jdraw.merge_object_masks(want))
    m1 = np.zeros((5, 6), dtype=int)
    m1[:4, :4] = 1
    m2 = np.zeros((5, 6), dtype=int)
    m2[2:, 2:] = 1
    merged = tdraw.merge_object_masks([m1, torch.as_tensor(m2)])
    assert merged[0, 0] == 1 and merged[4, 5] == 2
    assert tdraw.merge_object_masks([m1, m1]).max() == 1
    with pytest.raises(ValueError):
        tdraw.merge_object_masks([])


def test_parse_annot_rectangles():
    import pandas as pd
    row = pd.DataFrame([dict(ant_x=1, ant_y=2, lat_x=3, lat_y=4,
                             post_x=5, post_y=6)])
    assert tdraw.parse_annot_rectangles(row) == \
        jdraw.parse_annot_rectangles(row) == ([(1, 2)], [(3, 4)], [(5, 6)])
    srow = {c: '[ %i %i]' % (i, i + 10)
            for i, c in enumerate(tdraw.COLUMNS_POSITION_EGG_ANNOT)}
    assert tdraw.parse_annot_rectangles(srow) == \
        jdraw.parse_annot_rectangles(srow)


def test_overlap_images():
    rng = np.random.default_rng(3)
    imgs = [np.zeros((20, 20)), np.ones((20, 20)), rng.random((20, 20))]
    _eq(tdraw.make_overlap_images_optical(imgs),
        jdraw.make_overlap_images_optical(imgs))
    for field in (10, 7, tdraw.SIZE_CHESS_FIELD):
        _eq(tdraw.make_overlap_images_chess(imgs, chess_field=field),
            jdraw.make_overlap_images_chess(imgs, chess_field=field))
    chess = tdraw.make_overlap_images_chess(imgs[:2], chess_field=10)
    assert chess[0, 0] == 0 and chess[0, 10] == 1 and chess[10, 0] == 1


def test_colourings_match_matplotlib():
    """``jet`` through ``draw_color_labeling`` (int and float LUTs, 0 and
    negative maxima) and ``Greens`` through the unary-cost images (f32 and
    f64 costs, a zero cost, NaN)."""
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 40, (24, 30))
    for lut in (np.arange(40), rng.random(40), rng.integers(0, 7, 40),
                np.zeros(40), -rng.random(40), rng.random(40) * 1e-3):
        _eq(tdraw.draw_color_labeling(seg, lut),
            jdraw.draw_color_labeling(seg, lut))
    _eq(tdraw.draw_color_labeling(torch.as_tensor(seg), np.arange(40)),
        jdraw.draw_color_labeling(seg, np.arange(40)))
    for dtype in (np.float32, np.float64):
        cost = (rng.random((40, 3)) * 5).astype(dtype)
        cost[3] = 0
        cost[4, 1] = np.nan
        got = tdraw.draw_graphcut_unary_cost_segments(seg, cost)
        want = jdraw.draw_graphcut_unary_cost_segments(seg, cost)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _eq(g, w)


def test_colormap_tables_are_matplotlibs():
    """The port's 256-entry tables equal matplotlib's own, and their
    digests are the ones ``chip_smoke.py`` checks on the card's machine,
    where matplotlib is absent."""
    import hashlib
    for name, digest in chip_smoke.COLORMAP_SHA256.items():
        cmap = plt.get_cmap(name)
        cmap(0.5)
        want = np.ascontiguousarray(cmap._lut[:256], np.float64)
        got = tdraw._colormap_table(name)
        np.testing.assert_array_equal(got, want)
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest


def _render(fig):
    fig.set_dpi(DPI)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return buf


@pytest.mark.parametrize('name', FIGURES)
def test_figures_render_as_jax(name):
    args = chip_smoke.figure_cases().get(name, (None, (30, 40)))
    bufs = []
    for mod in (jdraw, tdraw):
        fn = getattr(mod, name)
        if name == 'figure_image_adjustment':
            fig = plt.figure()
            plt.imshow(np.zeros(args[1]))
            bufs.append(_render(fn(fig, args[1])))
        elif name == 'create_figure_by_image':
            fig, ax = fn(*args)
            ax.plot([0, 1], [1, 0])
            bufs.append(_render(fig))
        elif name == 'draw_graphcut_weighted_edges':
            with matplotlib.rc_context({'figure.dpi': DPI}):
                bufs.append(fn(*args))
        elif name.startswith('draw_'):
            fig, ax = plt.subplots()
            fn(ax, *args)
            bufs.append(_render(fig))
        else:
            bufs.append(_render(fn(*args)))
    assert bufs[0].shape == bufs[1].shape
    np.testing.assert_array_equal(bufs[1], bufs[0])


def test_figure_default_contour_colormap():
    """``figure_image_segm_centres`` resolves its ``Blues`` default when
    called; given explicitly it draws the same figure."""
    img, seg = chip_smoke.figure_cases()['figure_image_segm_centres'][:2]
    _eq(_render(tdraw.figure_image_segm_centres(img, seg)),
        _render(tdraw.figure_image_segm_centres(img, seg,
                                                cmap_contour=plt.cm.Blues)))


_NO_MATPLOTLIB = """
import inspect
import sys
sys.modules['matplotlib'] = None
import numpy as np
from pyimsegm_tpu_torch.utils import drawing
names = %r
for name in names:
    fn = getattr(drawing, name)
    n_args = sum(p.default is p.empty
                 for p in inspect.signature(fn).parameters.values())
    try:
        fn(*([None] * n_args))
    except ImportError as err:
        assert 'matplotlib' in str(err), err
        assert name in str(err), err
    else:
        raise AssertionError(name + ' ran without matplotlib')
seg = np.arange(12).reshape(3, 4)
drawing.draw_color_labeling(seg, np.arange(12))
drawing.draw_graphcut_unary_cost_segments(seg, np.ones((12, 2)))
drawing.polygon_fill_coords([2, 2, 8, 8], [2, 8, 8, 2], (20, 20))
drawing.draw_eggs_rectangle([30, 50], [[10, 10]], [[20, 20]], [[35, 20]])
assert 'matplotlib.pyplot' not in sys.modules
print('ok')
"""


def test_without_matplotlib():
    """With matplotlib blocked, every figure function raises ``ImportError``
    naming matplotlib and itself, before it touches its arguments; the
    array functions run."""
    proc = subprocess.run(
        [sys.executable, '-c', _NO_MATPLOTLIB % (FIGURES[1:],)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'
