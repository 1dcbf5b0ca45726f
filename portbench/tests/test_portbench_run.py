"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: the port and the reference agree exactly there, so the
run is correct; with the reference in bfloat16 in the program's place (the
configurations' control, TF32, exists on a card alone; both are run there
by ``portbench/calibrate.py``), or with the timed path broken underneath
(an answer altered where it is produced), ``correct`` comes out false."""

import copy

import numpy as np
import pytest
import torch

from portbench import manifest, run

CELLS = ('sup_texture.tile2048x3600', 'gray3d_unsup.vol48x640x768')
TINY = {'tissue_tiles': {'shape': [150, 260], 'regions': 12},
        'blob_volumes': {'shape': [8, 48, 64], 'field_grid': [3, 5, 6]}}


def _tiny_cell(name):
    cell = manifest.cell(name)
    cell['mix'] = dict(copy.deepcopy(cell['mix']), pool=2, check_items=2,
                       warm_calls=1, trace_items=2,
                       **TINY[cell['mix']['kind']])
    return cell


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize('name', CELLS)
def test_run_is_correct_on_the_cpu(name):
    result, rows = run.run_cell(_tiny_cell(name), 2 ** 31 + 11, 0.5, 0,
                                device='cpu')
    assert result['correct'], rows
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert list(result)[-1] == 'checks'
    assert all(v == 0.0 for _, v, _, _ in rows)
    assert set(result['metrics']) == set(manifest.cell(name)['end_to_end'])


@pytest.mark.parametrize('name', CELLS)
def test_control_run_is_not_correct(name):
    cell = _tiny_cell(name)
    assert cell['config']['control'] == 'tf32'
    result, rows = run.run_cell(cell, 2 ** 31 + 13, 0.5, 0, device='cpu',
                                control='bfloat16')
    assert not result['correct'], rows
    assert result['failed'] == 0 and all(v == v for _, v, _, _ in rows)


def _flip_mrf(monkeypatch):
    """One superpixel's MRF label altered where the graph cut makes it."""
    from pyimsegm_tpu_torch.ops import graphcut
    real = graphcut.segment_graph_cut_general

    def broken(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0] = (out[0] + 1) % 2
        return out
    monkeypatch.setattr(graphcut, 'segment_graph_cut_general', broken)


def _shift_features(monkeypatch):
    """The features off by up to 1e-3 relative, a different amount for
    each segment, where the descriptors make them."""
    from pyimsegm_tpu_torch import descriptors
    for fn in ('compute_selected_features_img2d',
               'compute_selected_features_gray3d'):
        real = getattr(descriptors, fn)

        def broken(*args, _real=real, **kwargs):
            feats, names = _real(*args, **kwargs)
            wobble = torch.sin(torch.arange(feats.shape[0],
                                            dtype=feats.dtype))
            return feats * (1 + 1e-3 * wobble[:, None]), names
        monkeypatch.setattr(descriptors, fn, broken)


def _move_label(monkeypatch):
    """The first two columns of pixels given the labels of the next
    superpixel's, where the final labels are made (enforcement in 2D, SLIC
    in 3D)."""
    from pyimsegm_tpu_torch.ops import grid, slic3d
    for mod, fn, step in ((grid, 'enforce_grid_connectivity', 36),
                          (slic3d, 'slic3d_segment', 16)):
        real = getattr(mod, fn)

        def broken(*args, _real=real, _step=step, **kwargs):
            out = _real(*args, **kwargs).clone()
            out[..., :2] = out[..., _step:_step + 2]
            return out
        monkeypatch.setattr(mod, fn, broken)


@pytest.mark.parametrize('fault', (_flip_mrf, _shift_features, _move_label))
@pytest.mark.parametrize('name', CELLS)
def test_run_with_a_broken_answer_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, rows = run.run_cell(_tiny_cell(name), 2 ** 31 + 12, 0.5, 0,
                                device='cpu')
    assert not result['correct'], rows


def test_measurement_path_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    code = run.main(['--workload', CELLS[0], '--seed', '1', '--seconds', '1',
                     '--trace', '0'])
    out = capsys.readouterr()
    assert code != 0 and out.out == ''
    assert 'CUDA' in out.err


def test_measurement_path_fails_without_the_program(monkeypatch, capsys):
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(importlib.util, 'find_spec', lambda name, *a: (
        None if name == run.PROGRAM else real(name, *a)))
    code = run.main(['--workload', CELLS[0], '--seed', '1', '--seconds', '1',
                     '--trace', '0'])
    out = capsys.readouterr()
    assert code != 0 and out.out == ''
    assert run.PROGRAM in out.err


def test_pool_repeats_for_a_seed_and_differs_across_seeds():
    mix = _tiny_cell(CELLS[0])['mix']
    from portbench.traffic import generate
    a = generate.make_pool(mix, 2 ** 31 + 5, 'cpu')
    b = generate.make_pool(mix, 2 ** 31 + 5, 'cpu')
    c = generate.make_pool(mix, 7, 'cpu')
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].shape == (150, 260, 3) and a[0].dtype == np.float32
    assert 0.0 <= a[0].min() and a[0].max() <= 1.0
