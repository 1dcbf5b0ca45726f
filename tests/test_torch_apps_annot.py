"""The port's host-side apps (annotation statistics, egg evaluation, centre
annotations, cuts, orientation, ellipse matching and cutting, the
annotation-handling CLIs, the figure sheets and the centre editor's dry
run) against the JAX package's apps on the same files, on the CPU, on the
200x260 slices of ``tests/test_torch_apps_ovary.py``.

Each app of either package writes into its own folder; every file either
writes is compared: images pixel for pixel (the figures too: both render
with matplotlib's Agg at the same dpi), TXT / JSON byte for byte, CSVs by
column names, index and text cells exactly and numbers within rtol 1e-6
+ atol 1e-6 (the segmentation metrics: JAX sums its ARS in f32, the port
in float64; they differ by ~1e-7), the experiments' logs and configs aside."""

import filecmp
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from PIL import Image  # noqa: E402

from test_torch_apps_ovary import ovary_dataset  # noqa: F401,E402

from torch_threads import one_torch_thread  # noqa: F401,E402

#: two eggs each on two images, as (row, col, semi-major, semi-minor,
#: orientation) ellipses, and the landmark table the user annotates
ELLIPSES = {'egg_a': [(60., 80., 40., 25., 0.3), (140., 190., 35., 28., 1.2)],
            'egg_b': [(100., 70., 45., 30., 2.0), (90., 190., 30., 22., 0.7)]}


def _compare_trees(jdir, tdir, skip=('logging.txt', 'config.yml',
                                     'resultStat.txt')):
    """Both trees hold the same files, equal (images by pixels)."""
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jdir)
                    for d, _, fs in os.walk(jdir) for f in fs
                    if f not in skip)
    tfiles = sorted(os.path.relpath(os.path.join(d, f), tdir)
                    for d, _, fs in os.walk(tdir) for f in fs
                    if f not in skip)
    assert tfiles == jfiles and jfiles
    for rel in jfiles:
        a, b = os.path.join(jdir, rel), os.path.join(tdir, rel)
        if rel.endswith(('.png', '.jpg', '.tif')):
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)), rel)
        elif rel.endswith('.csv'):
            _same_frames(a, b)
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
    return jfiles


def _same_frames(path_a, path_b):
    import pandas as pd
    dfa = pd.read_csv(path_a, index_col=0)
    dfb = pd.read_csv(path_b, index_col=0)
    assert list(dfa.columns) == list(dfb.columns), path_b
    assert list(dfa.index) == list(dfb.index), path_b
    num = dfa.select_dtypes('number').columns
    np.testing.assert_allclose(dfb[num].values, dfa[num].values, rtol=1e-6,
                               atol=1e-6, err_msg=path_b)
    other = [c for c in dfa.columns if c not in num]
    assert dfa[other].equals(dfb[other]), path_b


def _both(tmp_path, run):
    """``run(package, out)`` for JAX's app and the port's, then compare."""
    run('jax', tmp_path / 'jax')
    run('torch', tmp_path / 'torch')
    return _compare_trees(tmp_path / 'jax', tmp_path / 'torch')


def _apps(name):
    import importlib
    return (importlib.import_module('apps.' + name),
            importlib.import_module('pyimsegm_tpu_torch.apps.' + name))


def _pick(pkg, name):
    jmod, tmod = _apps(name)
    return jmod if pkg == 'jax' else tmod


@pytest.mark.parametrize('visual', [False, True])
def test_stat_annot_segm_app(ovary_dataset, tmp_path, visual):
    root = ovary_dataset

    def run(pkg, out):
        df = _pick(pkg, 'run_compute_stat_annot_segm').stat_annot_segm({
            'path_annot': str(root / 'segm' / '*.png'),
            'path_segm': str(root / 'annot' / '*.png'),
            'path_img': str(root / 'image' / '*.png'),
            'path_out': str(out), 'drop_labels': [1], 'visual': visual})
        assert len(df) == 7
    files = _both(tmp_path, run)
    assert sum(f.endswith('_overlap.png') for f in files) == (7 if visual
                                                             else 0)


def test_ovary_segm_evaluation_app(ovary_dataset, tmp_path):
    root = ovary_dataset
    methods = tmp_path / 'methods'
    for method, shift in (('same', 0), ('shifted', 5)):
        (methods / method).mkdir(parents=True)
        for s in range(3):
            annot = np.asarray(Image.open(root / 'annot' / ('slice_%i.png'
                                                            % s)))
            Image.fromarray(np.roll(annot, shift, axis=1)[:, ::-1]
                            if shift else annot).save(
                methods / method / ('slice_%i.png' % s))

    def run(pkg, out):
        _pick(pkg, 'run_ovary_segm_evaluation').main({
            'path_segms': str(methods),
            'path_annots': str(root / 'annot' / '*.png'),
            'path_out': str(out)})
    _both(tmp_path / 'res', run)


def test_create_annotation_and_cut_apps(ovary_dataset, tmp_path):
    root = ovary_dataset

    def run(pkg, out):
        _pick(pkg, 'run_create_annotation').main({
            'path_annots': str(root / 'annot' / 'slice_[0-2].png'),
            'path_out': str(out / 'ctr'), 'radius_center': 5,
            'radius_ring': 12})
        for mask, rotate in ((False, False), (True, True)):
            _pick(pkg, 'run_cut_segmented_objects').main({
                'path_annot': str(root / 'annot' / 'slice_[0-1].png'),
                'path_image': str(root / 'image' / 'slice_[0-1].png'),
                'path_out': str(out / ('cut_%s_%s' % (mask, rotate))),
                'padding': 3, 'mask': mask, 'no_rotate': not rotate})
    files = _both(tmp_path, run)
    assert sum(f.startswith('cut_True') for f in files) == 8


@pytest.mark.parametrize('swap_type', ['cc', 'density'])
def test_egg_swap_orientation_app(ovary_dataset, tmp_path, swap_type):
    root = ovary_dataset
    from pyimsegm_tpu_torch.apps import run_cut_segmented_objects as cut
    cut.main({'path_annot': str(root / 'annot' / 'slice_[0-2].png'),
              'path_image': str(root / 'image' / 'slice_[0-2].png'),
              'path_out': str(tmp_path / 'cut'), 'padding': 2,
              'mask': True, 'no_rotate': False})

    def run(pkg, out):
        _pick(pkg, 'run_egg_swap_orientation').main({
            'path_images': str(tmp_path / 'cut' / '*.png'),
            'path_out': str(out), 'swap_type': swap_type})
    _both(tmp_path / 'res', run)


def test_export_user_annot_segm_app(ovary_dataset, tmp_path):
    root = ovary_dataset

    def run(pkg, out):
        _pick(pkg, 'run_export_user_annot_segm').main({
            'path_images': str(root / 'image' / 'slice_[0-1].png'),
            'path_annots': str(root / 'annot' / 'slice_[0-1].png'),
            'path_segms': str(root / 'segm' / 'slice_[0-1].png'),
            'path_out': str(out)})
    assert len(_both(tmp_path, run)) == 2


def test_annotation_handling_apps(ovary_dataset, tmp_path):
    """Relabel, inpaint, label <-> colour conversion (both directions),
    quantisation (by colour on the device, by position) and the overlap
    sheets."""
    root = ovary_dataset
    colours = tmp_path / 'colours'
    from pyimsegm_tpu_torch.apps.handling_annotations import \
        run_image_convert_label_color as conv
    conv.convert_folder_images({
        'path_images': str(root / 'segm' / 'slice_[0-2].png'),
        'path_out': str(colours), 'direction': 'labels2colors',
        'path_colors': ''})
    noisy = tmp_path / 'noisy'
    noisy.mkdir()
    rng = np.random.default_rng(0)
    for s in range(3):
        img = np.asarray(Image.open(colours / ('slice_%i.png' % s))).astype(
            int)
        hit = rng.random(img.shape[:2]) < 0.02
        img[hit] = np.clip(img[hit] + rng.integers(-20, 21, (hit.sum(), 3)),
                           0, 255)
        Image.fromarray(img.astype(np.uint8)).save(noisy / ('slice_%i.png'
                                                            % s))
    holes = tmp_path / 'holes'
    holes.mkdir()
    for s in range(3):
        segm = np.asarray(Image.open(root / 'segm' / ('slice_%i.png' % s)))
        segm = segm.astype(np.uint8).copy()
        segm[40:60, 50:90] = 255
        Image.fromarray(segm).save(holes / ('slice_%i.png' % s))

    def run(pkg, out):
        pre = 'handling_annotations.'
        _pick(pkg, pre + 'run_segm_annot_relabel').relabel_folder({
            'path_images': str(root / 'segm' / 'slice_[0-2].png'),
            'path_out': str(out / 'relabel'), 'label_old': [2, 3],
            'label_new': [1, 1]})
        _pick(pkg, pre + 'run_segm_annot_inpaint').inpaint_folder({
            'path_images': str(holes / '*.png'),
            'path_out': str(out / 'inpaint'), 'label': 255})
        for direction, src in (('labels2colors', root / 'segm'),
                               ('colors2labels', colours),
                               ('auto', root / 'segm')):
            _pick(pkg, pre + 'run_image_convert_label_color')\
                .convert_folder_images({
                    'path_images': str(src / 'slice_[0-2].png'),
                    'path_out': str(out / ('conv_' + direction)),
                    'direction': direction, 'path_colors': ''})
        for method in ('color', 'position'):
            extra = {'device': 'cpu'} if pkg == 'torch' else {}
            _pick(pkg, pre + 'run_image_color_quantization')\
                .quantize_folder_images(dict({
                    'path_images': str(noisy / '*.png'),
                    'path_out': str(out / ('quant_' + method)),
                    'px_threshold': 1e-3, 'method': method}, **extra))
        _pick(pkg, pre + 'run_overlap_images_segms').export_overlaps({
            'path_images': str(root / 'image' / 'slice_[0-1].png'),
            'path_segms': str(root / 'segm' / 'slice_[0-1].png'),
            'path_out': str(out / 'overlap'), 'overlap': 0.3})
    files = _both(tmp_path / 'res', run)
    assert len(files) == 3 * 7 + 2 + 3


def _landmarks(tmp_path, root):
    """The info table of the landmark annotations (tab-separated) and one
    ellipse CSV per image (``xc, yc, a, b, theta``), the images beside."""
    import pandas as pd
    rows = []
    (tmp_path / 'ellipses').mkdir()
    (tmp_path / 'images').mkdir()
    for k, (name, ells) in enumerate(sorted(ELLIPSES.items())):
        Image.open(root / 'image' / ('slice_%i.png' % k)).save(
            tmp_path / 'images' / (name + '.png'))
        pd.DataFrame(ells, columns=['xc', 'yc', 'a', 'b', 'theta']).to_csv(
            tmp_path / 'ellipses' / (name + '.csv'))
        for i, (r, c, a, b, phi) in enumerate(ells):
            u = np.array([np.cos(phi), np.sin(phi)])      # (row, col)
            v = np.array([-np.sin(phi), np.cos(phi)])
            ant, post = np.array([r, c]) - a * u, np.array([r, c]) + a * u
            lat = np.array([r, c]) + b * v
            rows.append({'image_path': name + '.png', 'stage': 2 + i,
                         'ant_x': int(ant[1]), 'ant_y': int(ant[0]),
                         'lat_x': int(lat[1]), 'lat_y': int(lat[0]),
                         'post_x': int(post[1]), 'post_y': int(post[0])})
    path = tmp_path / 'info.txt'
    pd.DataFrame(rows).to_csv(path, sep='\t')
    return path


def test_ellipse_match_and_cut_apps(ovary_dataset, tmp_path):
    path_info = _landmarks(tmp_path, ovary_dataset)

    def run(pkg, out):
        df = _pick(pkg, 'run_ellipse_annot_match').main({
            'path_info': str(path_info),
            'path_ellipses': str(tmp_path / 'ellipses' / '*.csv'),
            'path_out': str(out / 'match'), 'overlap_thr': 0.45})
        assert df['ellipse_Jaccard'].notna().all()
        _pick(pkg, 'run_ellipse_cut_scale').main({
            'path_info': str(out / 'match' / 'info_ovary_images_ellipses.csv'),
            'path_images': str(tmp_path / 'images'),
            'path_out': str(out / 'cut')})
    files = _both(tmp_path / 'res', run)
    assert sum(f.startswith('cut') for f in files) >= 2


def test_center_editor_dry_run(ovary_dataset, tmp_path):
    root = ovary_dataset

    def run(pkg, out):
        _pick(pkg, 'gui_annot_center_correction').main({
            'path_images': str(root / 'image' / 'slice_[0-1].png'),
            'path_centers': str(root / 'centers' / 'slice_[0-1].csv'),
            'path_out': str(out), 'dry': True})
    assert len(_both(tmp_path, run)) == 2
