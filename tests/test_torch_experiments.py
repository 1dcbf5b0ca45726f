"""The port's ``utils/experiments`` against the JAX package's on the CPU:
folders, logger, config YAML, the final statistics, the grid expansion,
the sequential / thread map and ``StageTimer``.  Text and files are
compared exactly, apart from the clock readings they print."""

import logging
import os
import re
import time

import numpy as np
import pytest
import torch

from pyimsegm_tpu.utils import experiments as jexp
from pyimsegm_tpu_torch.utils import experiments as texp

from torch_threads import one_torch_thread  # noqa: F401


def test_constants_and_helpers():
    for name in ('CONFIG_YAML', 'FILE_LOGS', 'RESULTS_TXT'):
        assert getattr(texp, name) == getattr(jexp, name)
    assert texp.get_nb_workers(0.5) == jexp.get_nb_workers(0.5)
    assert texp.get_nb_workers(0.0) == 1
    for var in ('abc', b'x', [0], (1,), np.zeros(2), 3, None):
        assert texp.is_iterable(var) == jexp.is_iterable(var)
    d = {'b': 2, 'a': [1, 2], 'long_name_here': {'x': 1}}
    assert texp.string_dict(d, 'H:', 10) == jexp.string_dict(d, 'H:', 10)


@pytest.mark.parametrize('stamp', [False, True])
def test_experiment_folders(tmp_path, stamp):
    got = texp.create_experiment_folder(str(tmp_path), 'exp', stamp)
    again = texp.create_experiment_folder(str(tmp_path), 'exp', stamp)
    assert os.path.isdir(got) and os.path.isdir(again)
    assert (got != again) == stamp
    if not stamp:
        assert got == os.path.join(str(tmp_path), 'exp')
    with pytest.raises(FileNotFoundError):
        texp.create_experiment_folder(str(tmp_path / 'missing'), 'exp')
    assert texp.create_subfolders(str(tmp_path), ['a', 'b/c']) == \
        jexp.create_subfolders(str(tmp_path / 'j'), ['a', 'b/c']) == 2


def test_config_yaml_round_trip(tmp_path):
    cfg = {'a': 1, 'arr': np.arange(3), 't': torch.arange(2), 's': 'x',
           'f': {'color': ['mean']}}
    texp.save_config_yaml(str(tmp_path / 't.yml'), cfg)
    jexp.save_config_yaml(str(tmp_path / 'j.yml'),
                          {k: v for k, v in cfg.items() if k != 't'})
    got = texp.load_config_yaml(str(tmp_path / 't.yml'))
    assert got['t'] == [0, 1]
    assert {k: v for k, v in got.items() if k != 't'} == \
        jexp.load_config_yaml(str(tmp_path / 'j.yml'))


def _strip_time(text):
    return re.sub(r'total time \(min\): [0-9.]+', 'total time', text)


def test_final_stat_and_logger(tmp_path):
    params = {'name': 'x', 'v': 2.5}
    stats = {'ARS': 0.9}
    for pkg, mod in (('j', jexp), ('t', texp)):
        os.makedirs(tmp_path / pkg)
        path = mod.append_final_stat(str(tmp_path / pkg), params, stats,
                                     time.time())
        assert os.path.basename(path) == mod.RESULTS_TXT
    assert _strip_time(open(tmp_path / 't' / texp.RESULTS_TXT).read()) == \
        _strip_time(open(tmp_path / 'j' / jexp.RESULTS_TXT).read())
    logger = texp.set_experiment_logger(str(tmp_path / 't'))
    try:
        logging.getLogger().setLevel(logging.INFO)
        logging.info('hello port')
        for handler in logger.handlers:
            handler.flush()
        assert 'hello port' in open(tmp_path / 't' / texp.FILE_LOGS).read()
        file_handlers = [h for h in logger.handlers
                         if isinstance(h, logging.FileHandler)]
        assert len(file_handlers) == 1
    finally:
        for handler in list(logger.handlers):
            if isinstance(handler, logging.FileHandler):
                logger.removeHandler(handler)
                handler.close()


def test_experiment_class(tmp_path):
    for mod in (jexp, texp):
        exp = mod.Experiment({'path_out': str(tmp_path), 'name': 'e'},
                             time_stamp=False)
        exp.run()
        path = exp.params['path_exp']
        assert os.path.isfile(os.path.join(path, mod.CONFIG_YAML))
        assert os.path.isfile(os.path.join(path, mod.RESULTS_TXT))
        root = logging.getLogger()
        for handler in list(root.handlers):
            if isinstance(handler, logging.FileHandler):
                root.removeHandler(handler)
                handler.close()
    with pytest.raises(FileNotFoundError):
        texp.Experiment({'path_out': str(tmp_path / 'missing')})


def test_extend_list_params_and_try_decorator():
    lp = [{'name': 'a', 'x': 1}, {'name': 'b'}]
    assert texp.extend_list_params(lp, 'x', [2, 3]) == \
        jexp.extend_list_params(lp, 'x', [2, 3])
    assert texp.extend_list_params(lp, 'x', 5) == \
        jexp.extend_list_params(lp, 'x', 5)

    def boom(v):
        raise ValueError(v)
    assert texp.try_decorator(boom)(1) is None
    assert texp.try_decorator(lambda v: v + 1)(1) == 2


@pytest.mark.parametrize('workers,ordered', [(1, True), (3, True),
                                             (3, False)])
def test_wrap_execute_sequence(workers, ordered):
    vals = list(range(10))
    got = list(texp.WrapExecuteSequence(lambda v: v * v, vals, workers,
                                        ordered=ordered))
    want = list(jexp.WrapExecuteSequence(lambda v: v * v, vals, workers,
                                         ordered=ordered))
    assert (got if ordered else sorted(got)) == \
        (want if ordered else sorted(want))
    assert len(texp.WrapExecuteSequence(abs, vals, workers)) == 10


def test_stage_timer(monkeypatch):
    """The host-clock contract and ``report()`` text of JAX's timer; on a
    CUDA device a stage synchronises before it reads the clock at its
    start and end, on the CPU never."""
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125] * 2)
    monkeypatch.setattr(time, 'perf_counter', lambda: next(ticks))
    reports = []
    for timer in (jexp.StageTimer(), texp.StageTimer(device='cpu')):
        with timer.stage('slic'):
            pass
        with timer.stage('mrf'):
            pass
        with timer.stage('slic'):
            pass
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert texp.StageTimer().stages == {}
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda device=None: synced.append(device))
    timer = texp.StageTimer(device='cuda')
    monkeypatch.setattr(time, 'perf_counter', lambda: 0.0)
    with timer.stage('a'):
        pass
    assert synced == [torch.device('cuda')] * 2
    texp.StageTimer(device='cpu')._sync()
    texp.StageTimer()._sync()
    assert len(synced) == 2
